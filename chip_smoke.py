#!/usr/bin/env python3
"""Drive the PyTorch port's serving, speculative-decoding and training
paths, dense and MoE, one rank and several ranks over a device mesh
(pipelined over 'pp' too, and resharded live onto another mesh), and the
composed worker (the port's operator attaching the card, then placing a
user's request for it and composing it, in process and over each remote
fabric backend, then coordinates from the REST_CM request's CDI spec,
bootstrap, staged probe), and the high-availability operator (three
replicas over six shard leases composing the card through a crash, a
planned handoff and a store outage, then over the fake apiserver's
``tpuc-mux/1`` wire with the fleet view, the SLO engine and the
lock-order witness on, then as the operator's own binary in separate
processes beside its node-agent daemon, whose device plugin hands the
card to a pod process), on one NVIDIA GPU and hold every CUDA kernel of
those paths against its plain PyTorch version.

    python3 chip_smoke.py [--seed N] [--nccl-world]

Needs one CUDA card, nvcc and the ``tpu_composer_torch`` package beside
this file; it exits nonzero without them. ``--nccl-world`` runs instead
phases 2 and 11 and then phases 17 and 18's world-of-4 tasks, plus a
bf16 run at pp = 4, in one world of 4 ranks over NCCL, one card each
(it needs 4 cards), with the same checks; then a composed slice of one
host of 4 GPUs: 4 processes join the world over NCCL from the
coordinate env ``slice_env`` writes, alone, and run ``qualify_slice``
across it (its NCCL allreduce bus bandwidth). Each phase prints one JSON
line and checks its own result; any failure raises and the script exits
nonzero. Phases, in order:

1. ``card``: the card, its power limit, torch and CUDA versions. The
   raw ``nvidia-smi --query-gpu=name,power.limit`` line follows it.
2. ``build``: nvcc seconds per kernel source (all three compile at once,
   with the host compiler's builds of the scheduler's ``tpusched.cc``
   and the node agent's ``gpunode.cc`` beside them) and ptxas's report
   per kernel (registers, spills); a
   spill in the tensor-core B3 or in K2 fails the phase.
2a. ``devtools``: the port's tooling on the card's host, outside every
   kernel path (it launches no kernel): the port's lint
   (``tpu_composer_torch.analysis``, 7 passes) over its default scope
   must find nothing; the port's ``crdgen.manifests()`` must equal
   ``deploy/crds``; the port's installer, built from ``deploy/`` into a
   temporary directory, and the H100 example must pass
   ``validate_all`` with no error; the installer's Deployment and
   DaemonSet must start ``python -m tpu_composer_torch`` and ``python -m
   tpu_composer_torch.agent.serve``. It prints each step's seconds.
2b. ``operator_image``: the port's operator image without docker:
   ``Dockerfile.torch`` replayed into a temporary directory
   (``tpu_composer_torch.api.image``: its build stage compiles the two
   native libraries with the port's builders on this host's compiler,
   its runtime stage copies the package and those two files), the tree
   made read-only; from that tree alone (PYTHONPATH the tree, a PATH
   with ``python`` and no compiler, the image's ENV) the node-agent
   daemon over the real ``/dev`` and ``/proc`` (``NODE_NAME`` as the
   DaemonSet sets it, its device plugin on) and one operator replica
   (``python -m tpu_composer_torch`` through ``ProcFleet``, the REMOTE
   agent, the fake apiserver and fabric) compose the card once: the
   request must be Running within 30 s with its child Online, the
   child's CDI spec naming the per-GPU node this process's CUDA context
   holds; ``libgpunode-*.so`` (in the agent) and ``libtpusched-*.so``
   (in the replica) must be mapped from the tree, the tree unchanged,
   and both processes must exit 0 on SIGTERM. No kernel; it prints the
   host ms of each step beside the card's name and power limit.
3. ``flash_fwd``: kernel K1 against its plain version over B in {1, 2},
   S in {8, 64, 256, 512}, H=8, KV=2, D=64, causal or not, bf16 (at both
   CTA heights, 16 and 64 rows) and fp32, with and without lse; times at
   the serving prefill shape, with the CTA height ``_fwd_rows`` picks
   there and both heights.
4. ``paged_decode``: kernel K2 (split pass and merge) against the gather
   path at the engine's decode shape (B=8, H=8, KV=2, Dh=64, Bs=16,
   MB=32), lengths in 1..512 plus a 0-length row and stale table slots,
   then full rows (every length 512) and rows inside one chunk (lengths
   1..64); fp32, bf16, int8; and at the MoE engine's MHA shape (KV=8,
   G=1, lengths 0..320). Two launches must give the same bits; the
   split geometry (chunk, n_split, CTAs) is printed.
5. ``flash_bwd``: kernels B3 (dQ) and B4 (dK/dV) against
   ``flash_bwd_plain`` over B in {1, 2}, S in {8, 64, 256, 512} at D=64
   and S=100 at D=128, H=8 over KV in {2, 8}, causal or not, fp32 and
   bf16, with and without an lse cotangent, each case checked on its
   own, bf16 GQA cases with B4's group split across CTAs and not; then K1
   with lse, B3 and B4 against their plain versions on the path's own
   inputs: the training shape (8, 512, 8, 2, 64, bf16, causal) and
   ``qualify_slice``'s MHA shape (8, 512, 8, 8, 64); B3 and B4 launched
   twice on the training-shape inputs must each give the same bits; the
   geometry chosen (CTA height, group split, CTA counts) and times at
   the training shape; then the multi-rank path's blocks (bf16): a
   ring block of sp = 2 at seq 512, the causal diagonal and a whole
   off-diagonal block, each with a live lse cotangent, and Ulysses'
   gathered sequence over half the heads, (8, 512, 4, 1, 64).
6. ``serve_exact``: the flagship at full width in fp32, prefill through
   K1 and decode through K2: every request's tokens equal the port's
   solo ``generate`` with reference attention.
7. ``serve``: the flagship in bf16: 16 greedy and sampled requests
   through an 8-slot engine, then an int8-pool engine with chunked
   admission and a shared prefix; tokens/s, step p50, launch counts;
   one mid-flight decode step of each engine through K2 against the
   gather path on copies of the same cache (``k2_midflight``).
8. ``moe_serve_exact``: the MoE flagship (``MoEConfig()``: vocab 32000,
   d_model 512, 4 layers, 8 MHA heads, d_ff 1408, 8 experts top-2 on
   layers 1 and 3) in fp32 with capacity_factor 4.0 (so the solo
   prefill drops nothing), a 4-slot engine with chunked admission and K2
   decode: every request's tokens equal its solo ``generate``.
9. ``moe_serve``: the MoE flagship in bf16, two 8-slot engines with
   chunked admission and a shared 64-token prefix, a bf16 pool (K2 fp)
   and an int8 pool (K2 int8), 16 greedy and sampled requests each;
   first-token logits against the drop-free plain path (an empty dense
   cache, fp or int8 as the pool, and ``decode_chunk`` over the prompt in
   the engine's chunks, reference attention);
   tokens/s, decode step p50, a profile of 8 decode steps with the MoE
   FFN's share; K2 mid-flight against the gather path, as in ``serve``.
10. ``speculative``: the MoE flagship in fp32 (prefill through K1) as
    target, its int8-quantized self as draft, gamma 4, 3 prompts of
    32-200 tokens, 64 new tokens, through ``speculative_generate`` and
    ``paged_speculative_generate``: tokens equal target-only greedy
    ``generate``; acceptance (the drafts accepted, 64 − 1 − rounds, over
    rounds × gamma), tokens/s of each beside ``generate``'s, host syncs
    a round.
11. ``train_exact``: the flagship in fp32, 3 AdamW steps on (4, 256)
   tokens with flash attention (K1 with lse, B3, B4) and 3 with
   reference attention from the same params: losses, grad norms and the
   first step's gradients agree.
12. ``train``: the flagship in bf16 through ``trainer.fit`` on packed
   synthetic Zipf documents (seq 512, batch 8): 20 steps checkpointed
   every 10, then a resumed ``fit`` to 24; tokens/s, step p50, one step
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
   step fails the phase), the device's busy share, and the step's device
   ms with the tied head's two routes in turns (bf16 operands into an
   fp32 output, and both upcast first).
13. ``qualify``: ``qualify_slice()`` at its defaults.
14. ``train_moe``: the MoE flagship in fp32, 3 steps on (4, 256) tokens
    with flash attention (K1 with lse, B3, B4) and 3 with reference
    attention from the same params (the tokens whose top-1 expert
    differs between the two are counted); then bf16 at seq 512, batch 8,
    12 steps on packed Zipf documents: step p50 and tokens/s.
15. ``mesh_train``: a world of 2 ranks and one of 4, spawned on the one
    card over gloo (NCCL refuses two ranks on one GPU, so every
    collective is staged through the host), each rank on the card and
    its kernels built by phase 2. The fp32 flagship (tokens (4, 256), 3
    AdamW steps from the same params) over sp = 2 ring, zigzag and
    Ulysses with the flash inner, ring with the einsum inner, tp = 2,
    dp = 2 and (world 4) sp = 4 zigzag: losses, grad norms and the first
    step's gradients (gathered to rank 0) against ``train_exact``'s
    one-process flash step; the fp32 MoE flagship over ep = 2 and
    (world 4) ep = 2 x sp = 2 Ulysses/flash against ``train_moe``'s
    losses, with the flipped top-1 choices; the bf16 flagship at seq
    512, global batch 8, 12 steps over sp = 2 ring/flash: the loss
    falls, per rank its step p50 and K1-with-lse, B3 and B4 launches a
    step; one bf16 flagship step at dp = 2 x tp = 2 (world 4) under
    ``record_collectives``, each rank's bytes per mesh dim against their
    closed form (over dp its gradient bytes and two fp32 scalars). Ranks
    print nothing to stdout and send the parent their
    results; a rank's failure or a world past its deadline fails the
    phase, and no rank is left running. The worlds stay up for phases
    17 and 18.
16. ``mesh_nccl``: one rank over NCCL: ``fit`` 3 steps over
    ``make_mesh`` of the card gives the meshless ``fit``'s losses bit
    for bit; ``allreduce_bandwidth_gbps`` reports 0.0.
17. ``pipeline_train``: GPipe over 'pp', as the second stage of phase
    15's worlds (each rank sets its counts to 0 before each stage).
    First, in this process and uncounted, K1 with lse, B3 and B4 against
    their plain versions at the pipeline's and the reshard's shapes
    (bf16 (2, 512, 8/2, 64); fp32 (2, 256, 8/2, 64), (1, 256, 8/2, 64),
    tp = 2's (2, 256, 4/1, 64) and (4, 256, 4/1, 64); K1 without lse at
    fp32 (2, 256, 8/2, 64)), and the three kernels' device times at the
    bf16 one.
    Exact half: the fp32 flagship (tokens (4, 256), 3 AdamW steps)
    pipelined over pp = 2 with M = 2, pp = 4 with M = 4 (one layer a
    stage, one row a microbatch), pp = 2 × tp = 2, pp = 2 × dp = 2 and
    pp = 2 × sp = 2 with the ring's einsum inner, against
    ``train_exact``'s one-process flash step; ``pipelined_forward`` under
    ``no_grad`` at pp = 2 (K1 without lse) against ``forward``. Run
    half: the bf16 flagship at seq 512, global batch 8, pp = 2 with
    M = 4, 12 steps: the loss falls, per rank its step p50 and flash
    launches a step.
18. ``reshard_train``: the third stage of phase 15's world of 4, the
    fp32 flagship with flash attention: 3 steps on tp = 2 over ranks
    0-1, ``reshard_train_state`` onto dp = 2 × tp = 2, 2 more steps, and
    the shrink the other way; a checkpoint saved on pp = 2 (ranks 0-1)
    restored onto pp = 2 × dp = 2. The state gathered on the target mesh
    equals the one gathered (or saved) on the source, bit for bit, and
    the losses after it equal the never-resized run's.
19. ``operator_attach``: the port's operator composes this card: a
    ``LocalNodeAgent`` on the real ``/dev`` and ``/proc`` (its CDI and
    state directories under the run's workdir), a Store with a Node
    ``localhost`` of one slot per GPU the agent lists, an ``InMemoryPool``
    with the slice ``chip-smoke`` reserved at ``1x1``, and a threaded
    ``Manager`` running ``ComposableResourceReconciler`` with 2 workers;
    then the CR (type gpu, ``nvidia-h100-sxm``, ``localhost``, 1 chip,
    worker 0, ``1x1``). Within 30 s it must be Online through the device
    scan; its CDI spec file's env must equal the hand composition's
    (``_compose_one_gpu``); its per-GPU node must be the node this
    process's CUDA context holds open, the card CUDA runs on (and, where
    the host's driver reports PCI bus ids, the same bus id as CUDA's); the
    ResourceSlice must list the device. It prints the attach-to-Online
    host milliseconds beside the card's name and power limit, the nodes,
    minors and bus ids, and the spec's name. The control plane never
    touches CUDA.
20. ``operator_busy``: the node agent's busy guard on that group:
    ``check_no_loads`` is False and ``drain(force=False)`` raises
    ``DeviceBusyError`` naming this process's pid, whose CUDA context
    holds the card open. Then that Manager stops. The card runs no
    controller detach: the in-memory fabric cannot take the card off the
    host, so the node keeps enumerating and a detach would wait in
    Detaching for good (the CPU tests run it over a fake device tree).
21. ``operator_request``: the user's path into the operator: a fresh
    Store, ``InMemoryPool`` and ``LocalNodeAgent`` (its own CDI and state
    directories), the Node ``localhost`` of one slot per listed GPU, a
    ``ClusterScheduler`` on the port's native scan (``tpusched.cc``, built
    by phase 2) with its decision ledger, and a ``Manager`` (health port
    on localhost) running the request and resource reconcilers with 2
    workers each. The request ``chip-smoke`` (type gpu,
    ``nvidia-h100-sxm``, size 1, no target node: the scan must choose the
    host) must be Running within 30 s with ``status.slice``
    (``chip-smoke-slice``, ``1x1``, 1 host, 1 GPU, ``localhost``), the
    pool's reservation made by the controller, exactly one child Online
    through the device scan, its CDI spec env equal to ``slice_env`` of
    that slice and to the hand composition renamed, its per-GPU node the
    one CUDA's context holds, ``last_scan_kind == "native"``, and
    ``/debug/scheduler/explain/chip-smoke`` naming ``localhost``. A
    second request of size 1 must stay queued with an AllocationError,
    its explain record giving ``localhost``'s verdict (``no-tpu-ports
    free=0 need=1``). It prints the request-to-Running host ms, the
    placement decision's ms (its ``scheduler.decide`` span), the native
    build's seconds, the spec's name and the nodes, beside the card's
    name and power limit. This Manager runs on through phase 24.
22. ``operator_remote``: the same user's request through each remote
    fabric backend, REST_CM, REST_FM, LAYOUT and REDFISH, in turn. Each
    gets its own ``tests/torch_fake_fabric.py`` server (a fresh
    ``InMemoryPool``, ``require_auth``: the token path is on the wire),
    a provider from ``new_fabric_provider(kind)`` with
    ``FABRIC_ENDPOINT`` (and the token env) pointing at that server,
    which must come back behind the circuit breaker, and a fresh Store,
    ``LocalNodeAgent`` and native-scan ``ClusterScheduler``; a
    ``FabricDispatcher`` stands in front of both reconcilers and the
    ``Manager`` (``dispatcher=``, with cold-start adoption as its startup
    hook), and for REST_CM a ``FabricSession`` long-polls the server's
    ``/v1/events``. The request ``chip-smoke`` (gpu, ``nvidia-h100-sxm``,
    size 1) must be Running with its one child Online within 30 s; the
    fabric's reservation, the child's CDI id and spec env (equal to the
    hand composition's and to ``slice_env``), the spec's control nodes
    (the hand composition's) and GPU node (the card CUDA holds), the
    native scan, a fetched token and a dispatcher call are checked. It
    prints, per backend, the request-to-Running host ms, the wire
    requests (by route), the token fetches, the dispatcher's provider
    calls (group or single) and the session's events. The other three
    operators stop at once (each Manager's stop drains its dispatcher);
    REST_CM's runs on through phase 25. No backend falls back to the
    in-process pool.
23. ``composed_worker``: the H100 worker the operator composed. First,
    in this process and uncounted, K1 without and with lse, B3 and B4
    against their plain versions at the staged probe's flash sweep (bf16,
    causal, head_dim 128: (2, 1024, 8/8), (2, 2048, 8/2), (1, 4096, 8/2),
    (1, 8192, 4/1)) and at ``qualify_large``'s (8, 2048, 16/16), with
    device times and bounds beside SDPA's forward and backward; K2
    against the gather path at the decode stage's geometry (16 heads over
    4, Dh 64, blocks of 128, 2 slots a row, lengths 129-256; fp32, bf16,
    int8). Then the coordinate env read back from the CDI spec file of
    the REST_CM request's child (phase 22), ``SliceCoords.from_env``,
    ``bootstrap_distributed``, and ``staged_accelerator_probe`` run on the
    card with that env: every stage completes with no error and nothing
    skipped, flash numerics hold, the child rebuilds no kernel, and its
    stages' launches are the path's.
24. ``operator_request_busy``: phase 20's busy guard on the request's
    child group; then phase 21's Manager stops, with no delete on the
    card (see phase 20).
25. ``operator_remote_busy``: the same guard on the REST_CM child's
    group; then that operator stops, its Manager draining the dispatcher
    (one clean drain), and its fake fabric server closes.
26. ``operator_ha``: the high-availability operator, 3 replicas over
    K = 6 shard leases (lease 3 s, renew every 0.25 s, renew deadline
    2 s). One Store, wrapped in a ``ChaosStore``; per replica a crash fuse
    over it, a ``BreakingStore`` and a ``CachedClient``, a
    ``ShardLeaseElector`` on the fuse, a ``FabricDispatcher`` with
    ``owns=``, both reconcilers with ``ownership=`` on the native scan, a
    ``Manager`` with ``replica_id``, the overload governor (its shed gate
    on the request controller), the watchdog and the store breaker, and
    the shard hooks (scoped adoption on acquire, resync on ready, lane
    fencing on lose); one ``InMemoryPool`` whose attaches take two
    re-polls, and one ``LocalNodeAgent`` for the node ``localhost``
    (its CDI and state directories), shared by the replicas as a node's
    agent is. The request ``chip-smoke-ha`` (gpu, ``nvidia-h100-sxm``,
    size 1) is submitted and the replica owning its shard crashes once
    its cache shows the child with an attach intent, not Online: every
    store call fails from then on, its watch goes silent, its dispatcher
    is killed; no drain, no lease release (the crash state is printed).
    Its renew loop fences its shards at the renew deadline, and its own
    reconcile of the child, run by hand, must raise ``ShardFencedError``
    with no fabric call. Within the lease duration plus 30 s a survivor
    holds the shard, the request is Running with exactly one child
    Online through the device scan, its CDI spec env equals
    ``slice_env`` and the hand composition's, its GPU node is the one
    CUDA's context holds, and the pool shows one reservation and one
    attach of the child. As the composed worker's first work, K1 without
    lse at the serving prefill shape (1, 256, 8/2, 64, bf16, causal) and
    K2 at the dense engine's decode shape (8 rows, 8/2 heads, 64, blocks
    of 16, 32 slots, bf16) run once each in this process, held to their
    plain versions. Then, once the survivors have rebalanced, a planned
    stop of the survivor owning the shard: one clean dispatcher drain,
    the leases released, the third replica holding the shard within one
    renew period. Last, ``ChaosStore.blackout_for(1.0)`` as a second
    size-1 request arrives: ``/debug/storebreaker`` shows the breaker
    trip and close, ``/debug/overload`` and ``/debug/watchdog`` answer
    200, and the request ends held back with its AllocationError explain
    record (``no-tpu-ports free=0 need=1``) and no child. It prints the
    crash-to-fenced, crash-to-shard-acquired and crash-to-Running ms, the
    handoff's ms, the lease timings, and the store round trips from
    submission to Running (by verb and kind, leases aside) beside the
    cached reads, with the card's name and power limit.
27. ``operator_ha_busy``: phase 20's busy guard on the survivor's child
    group; then the remaining replicas stop (the card runs no detach).
28. ``operator_fleet``: the operator over the apiserver's wire. The
    port's ``FakeApiServer`` on 127.0.0.1 (the ``tpuc-mux/1`` transport
    on), seeded with the operator's routes and the core Node
    ``localhost`` advertising its GPUs under ``tpu.composer.dev/chips``;
    3 replicas over K = 6 shard leases (the timings of phase 26), each
    with its own ``KubeStore`` (mux, pinged every 0.25 s) behind a crash
    fuse, a ``CachedClient``, a ``ShardLeaseElector``, a dispatcher with
    ``owns=``, both reconcilers with ``ownership=``, an ``SloEngine`` on
    the default objectives (evaluated every 0.25 s) and a ``FleetPlane``
    (publish every 0.25 s, stale after 1 s), and phase 26's shard hooks;
    ``replica-c`` dials through the port's ``ChaosProxy``. The port's
    lock-order witness runs strict from the phase's start to phase 29's
    end. The request (gpu, ``nvidia-h100-sxm``, size 1, named so that
    its owner is not the proxied replica) is submitted and its owner
    crashes mid-attach, as in phase 26; within the staleness window plus
    two publish periods (and 0.5 s) both survivors' ``/debug/fleet``
    show the victim ``stale: true`` and 2 live replicas; the victim's
    hand reconcile raises ``ShardFencedError`` with no fabric call; a
    survivor takes the request to Running with one reservation and one
    attach, held to phase 21's checks (status.slice, the reservation,
    one Online child, the spec env against ``slice_env`` and the hand
    composition, the GPU node CUDA holds). The fleet-merged
    attach-to-ready count equals the process registry's own (three
    replicas, one process token: counted once); ``/debug/slo`` lists
    the four default objectives with finite burn rates. K1 and K2 run
    once each as in phase 26. Then the proxied replica's wire goes dark
    for 1 s (its connections reset, new ones silent until the heal): its
    ``KubeStore`` reconnects, its watches resume or relist, and it reads
    the request Running, keeping its shards. No ``KubeStore`` fell back
    to plain HTTP, and ``/debug/lockdep`` reports no violation. It prints
    request-to-Running and crash-to-Running ms (both over the wire, the
    first including the failover), crash-to-stale ms, wire requests by
    verb per replica, mux frames (both sides, this process) and
    reconnects, the drop's relists and watch resumes, each replica's
    fleet publish and aggregate ms, the local and fleet burn rates and
    the witness's edge count, with the card's name and power limit.
29. ``operator_fleet_busy``: a second size-1 H100 request over the
    wire, on the full host: held back with its explain record
    (``no-tpu-ports free=0 need=1``) and no child, the witness still
    clean; then the replicas, the proxy and the apiserver stop.
30. ``operator_binary``: the card composed by the port's binary across
    processes. It prints the seconds of phase 2's build of the node
    agent's native library (``native/gpunode.cc``); starts the
    node-agent daemon (``python -m tpu_composer_torch.agent.serve`` over
    the real ``/dev`` and ``/proc``, its kubelet device plugin on a
    unix socket), which must load that same library (its log and its
    ``/proc/<pid>/maps``); then, through ``fleet.ProcFleet`` (the port's
    fake apiserver and ``tests/torch_fake_fabric.py`` in this process, a
    Node ``localhost`` of one H100, the pool's attach taking 1 s), three
    ``python -m tpu_composer_torch`` replicas over K = 6 shards (lease
    3 s, renew 0.25 s, ``NODE_AGENT=REMOTE`` at the daemon, a plain
    webhook server on ``127.0.0.1:0``, ``operator_fleet``'s cuts
    through the binary's variables). One size-1 H100 request is POSTed
    to the apiserver; the replica whose shard holds its child is
    killed -9 mid-attach (its ``/debug/traces`` snapshotted first), and
    a survivor takes the request to Running within the lease + 30 s,
    with one attach in the pool's event log. The daemon's CDI spec
    holds ``slice_env`` and the card CUDA holds open; a live replica's
    webhook patches a labelled pod with exactly ``inject_pod_env``, and
    denies an invalid request with ``validate_request``'s message; the
    plugin's first ``ListAndWatch`` lists the card and ``Allocate``
    answers its node, the control nodes, its CDI name and
    ``CUDA_VISIBLE_DEVICES``. A pod process started with the webhook's
    and Allocate's env runs K1 and K2 once each against their plain
    versions (bf16 2e-2) on the composed card (its PCI bus id and
    device node), building nothing, and reports its launch counts;
    ``python -m tpu_composer_torch explain`` renders the placement and
    names ``localhost``. It prints kill-to-Running and
    submission-to-Running ms, each replica's spawn-to-port-file s, the
    webhook and Allocate round trips, and the apiserver's requests by
    verb from submission to Running, with the card's name and power
    limit.
31. ``operator_binary_busy``: a second size-1 H100 request, held back:
    ``explain`` shows ``no-tpu-ports free=0 need=1`` and it has no
    child; the daemon's drain guard names this process as the card's
    holder; every survivor is drained at once (``ProcFleet.drain``:
    exit 0, every shard lease released) and the daemon stopped by
    SIGTERM (exit 0); ``python -m tpu_composer_torch trace-merge`` over
    the survivors' trace files and the victim's snapshot gives one pid
    per replica and a flow from the victim's intent to a survivor's
    adoption.
32. ``timing`` (the whole run's seconds, builds included, and each
    phase's) and ``launches`` (per path: serving is phases 6-7,
    moe_serving 8-9, speculative 10, training 11-13, moe_training 14,
    mesh_training 15-16, pipeline_training 17, reshard_training 18,
    composed_worker 19-25, operator_ha 26-27, operator_fleet 28-29,
    operator_binary 30-31, the ranks', the probe child's and the pod's
    counts summed in); then the kernels line
    ``{"kernels": [...]}``: per kernel its launches summed over every
    path and by path, max error, kernel / plain / library ms (device
    time), the kernel's issue ms, and the bound.
33. the last line: ``{"ok": true, "device": {...}}``.

Times (``timed``): ``ms`` is device time, the calls queued behind a
spin kernel that outlasts the host's issue of all of them, so the CUDA
events bracket back-to-back device work; ``issue_ms`` is the same calls
bracketed as the host issues them, which is the host's pace once a call
takes less device time than its validation, allocation and ctypes call.
Every kernel, plain and library time is printed in both measures.

Tolerances (absolute unless said): K1 fp32 1e-4, bf16 2e-2, lse 1e-4.
K2 fp32 1e-4; bf16 2e-2 (the kernel keeps P in fp32, the gather path
rounds P to bf16 first). B3/B4 relative to each gradient's own max|ref|
in each case (printed beside the worst error): fp32 1e-4 (other
summation order); bf16 3e-2 (dS is rounded to bf16 before two
products). First-token logits of the bf16 engine against the plain path
5e-2; of the int8-pool engine against an unquantized prefill 1e-1 (the
same for the MoE engines, against the drop-free plain path).
``train_exact``: losses 1e-4, grad norms 1e-3 relative, gradients 1e-4
relative to max(1, max|ref|) (flash against reference attention, fp32).
``train_moe``: losses 1e-3 relative (one flipped routing choice moves
one token's FFN). ``mesh_train``, ``pipeline_train`` and
``reshard_train``: the dense
checks as ``train_exact``, against the one-process flash step; MoE
losses 1e-3 relative; the pipelined forward's logits 1e-4; the
resharded and restored runs' losses 2e-4 relative to the never-resized
run's (``tests/test_reshard.py``'s bound), their states equal to the
source's exactly. K2 mid-flight against the
gather path: 5e-2 (bf16 pool), 1e-1 (int8). ``operator_ha``'s and
``operator_fleet``'s and ``operator_binary``'s K1 and K2: bf16 2e-2. Token streams
(``serve_exact``, ``moe_serve_exact``, ``speculative``): equal; on a
mismatch the target's top-2 logit gap at the first diverging token is
printed (under 1e-4 names float drift).
fp32 matmuls run in full fp32 (TF32 off, below).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LSE_TOL = 1e-4
# At long causal sequences most output rows are averages over thousands of
# keys, far smaller than the early rows that set max|ref|: each row is also
# held to its own scale, max|ref| over the row's last dim, floored at
# ROW_FLOOR x the tensor's max|ref| so rows that are zero by construction
# (dq of row 0) are not held to their rounding noise.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
ROW_FLOOR = 1e-3
LOGIT_TOL_BF16 = 5e-2
LOGIT_TOL_INT8 = 1e-1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(2_000_000)
    b.record()
    b.synchronize()
    return 2_000_000 / a.elapsed_time(b)


def timed(fn, iters: int = 50, warmup: int = 5) -> tuple:
    """(device ms, issue ms) per call of ``fn`` over ``iters`` back-to-back
    calls, CUDA events around them, inputs warm in L2.

    issue ms: the events bracket the calls as the host issues them, so a
    call that takes less device time than the host's work to issue it
    (validation, allocation, ctypes) is timed at the host's pace.
    device ms: the same calls queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's issue of all of them
    by a margin, the start event recorded after the spin, so the events
    bracket back-to-back device work. The start event must still be
    pending when the last call is queued (the queue was full when the
    device reached it); if not, the spin doubles and the run repeats.
    The host blocks once about a thousand launches wait on the stream, so
    ``iters`` times the launches of one call stays well under that."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    issue_ms = start.elapsed_time(end) / iters
    spin_ms, cycles_per_ms = 2 * host_ms + 1.0, _spin_cycles_per_ms()
    tried = []  # (spin ms asked, host ms to queue the calls behind it)
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        t1 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        filled = not start.query()
        tried.append((spin_ms, (time.perf_counter() - t1) * 1e3))
        end.synchronize()
        if filled:
            return start.elapsed_time(end) / iters, issue_ms
        spin_ms *= 2
    raise RuntimeError(
        "the host never got ahead of the device: issue"
        f" {issue_ms * iters:.3f} ms and host {host_ms:.3f} ms for {iters}"
        f" calls unspun; behind each spin (ms asked, host ms to queue the"
        f" calls): {[(round(a, 3), round(b, 3)) for a, b in tried]};"
        f" calibration {cycles_per_ms:.1f} cycles/ms")


def timings(kernel, plain, library=None) -> dict:
    """Both measures of :func:`timed` for a kernel (one or two launches a
    call), its plain version (tens of launches a call) and, where there is
    one, its library yardstick (up to about ten)."""
    t = {}
    t["ms"], t["issue_ms"] = timed(kernel)
    t["plain_ms"], t["plain_issue_ms"] = timed(plain, iters=10)
    t["library_ms"], t["library_issue_ms"] = (
        timed(library, iters=20) if library is not None else (None, None))
    return t


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_err(got, want) -> float:
    """The worst row's max|got - want| over its own max|want| (rows along
    the last dim), the scale floored at ROW_FLOOR x max|want|."""
    w = want.float().abs()
    scale = w.amax(dim=-1).clamp_min(ROW_FLOOR * float(w.max()))
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return float((err / scale).max())


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("card", **card)
    print(smi, flush=True)
    return card


# Kernels that must compile without spills: the tensor-core B3 and K2's
# two kernels (every instantiation).
NO_SPILL = ("flash_bwd_dq_tc_kernel", "paged_decode_split_kernel",
            "paged_decode_merge_kernel")


def _ptxas_report(log: str) -> list:
    """[kernel, template arguments, registers, spill bytes] per kernel
    from ``nvcc -Xptxas=-v`` output; the names are read from the mangled
    symbol, its template arguments left mangled."""
    import re

    rows, current = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", ln)
        if m:
            name = re.search(r"\d+([a-z][a-z_]*_kernel)(I\w*?E)?E?v",
                             m.group(1))
            current = ([name.group(1), name.group(2) or "", None, 0]
                       if name else [m.group(1)[:60], "", None, 0])
            if not rows or rows[-1][:2] != current[:2]:
                rows.append(current)
            else:
                current = rows[-1]
        elif current is not None and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", ln)]
            current[3] = max([current[3]] + nums)
        elif current is not None and "Used" in ln:
            current[2] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return rows


def phase_build() -> None:
    import threading

    from tpu_composer_torch.agent import native as agent_native
    from tpu_composer_torch.ops import _build
    from tpu_composer_torch.scheduler import native

    t0 = time.perf_counter()
    # The host libraries (the scheduler's scan, the node agent's) compile
    # beside the CUDA sources.
    native_err = []

    def build_native():
        try:
            native.build_native()
            agent_native.build_native()
        except BaseException as e:  # re-raised below, on this thread
            native_err.append(e)

    host = threading.Thread(target=build_native, name="host-libs-build")
    host.start()
    try:
        seconds = _build.build(["flash_fwd", "paged_decode", "flash_bwd"])
    finally:
        host.join()
    if native_err:
        raise native_err[0]
    ptxas = {name: _ptxas_report(log)
             for name, (_, log) in _build.build_log.items()}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         ptxas=ptxas,
         tpusched_s=native.build_log.get("tpusched", (0.0,))[0],
         tpusched_lib=os.path.relpath(native.library_path(), HERE),
         gpunode_s=agent_native.build_log.get("gpunode", (0.0,))[0],
         gpunode_lib=os.path.relpath(agent_native.library_path(), HERE))
    for name, rows in ptxas.items():
        for kernel, targs, regs, spill in rows:
            check(not (kernel in NO_SPILL and spill),
                  f"{name}: {kernel}{targs} spills {spill} bytes")


#: The installer's container commands: the port's operator and node agent.
PORT_COMMANDS = {"Deployment": [["python", "-m", "tpu_composer_torch"]],
                 "DaemonSet": [["python", "-m",
                                "tpu_composer_torch.agent.serve"]]}


def phase_devtools(workdir: str) -> dict:
    """The port's tooling on the card's host, no kernel: its lint over
    its default scope, its CRDs against ``deploy/crds``, its installer
    validated with the H100 example, and the installer's two commands."""
    import yaml

    from tpu_composer_torch.analysis import all_passes, run_passes
    from tpu_composer_torch.analysis.core import discover_files
    from tpu_composer_torch.api import crdgen, packaging, validate_manifests

    steps = {}
    t0 = time.perf_counter()
    files = discover_files()
    passes = all_passes()
    violations = run_passes(passes, files=files)
    steps["lint"] = time.perf_counter() - t0
    check(len(passes) == 7 and not violations,
          f"the port's lint over {len(files)} files:"
          f" {[v.format() for v in violations]}")

    t0 = time.perf_counter()
    crds = os.path.join(HERE, "deploy", "crds")
    generated = crdgen.manifests()
    for name, doc in generated.items():
        with open(os.path.join(crds, name)) as f:
            check(yaml.safe_load(f) == doc,
                  f"deploy/crds/{name} differs from the port's crdgen")
    check(len(generated) == 4, f"crdgen made {sorted(generated)}")
    steps["crdgen"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    install = packaging.build_installer(
        os.path.join(HERE, "deploy"), os.path.join(workdir, "install.yaml"))
    steps["installer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    errors = validate_manifests.validate_all(
        crds, install,
        examples_dir=os.path.join(HERE, "tpu_composer_torch", "examples"))
    steps["validate"] = time.perf_counter() - t0
    check(errors == [], f"validate_all: {errors}")

    with open(install) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    commands = {d["kind"]: [c.get("command") for c in
                            d["spec"]["template"]["spec"]["containers"]]
                for d in docs if d["kind"] in PORT_COMMANDS}
    check(commands == PORT_COMMANDS,
          f"the installer's commands: {commands}")
    out = {"files_linted": len(files), "passes": len(passes),
           "violations": len(violations), "crds": sorted(generated),
           "installer_docs": len(docs), "validate_errors": len(errors),
           "commands": commands, "step_s": steps}
    emit("devtools", **out)
    return out


IMAGE_RUNNING_S = 30.0  # the image's request must be Running within this
IMAGE_REPLICA = "image-replica"


def _mapped_native(pid: int) -> list:
    """The port's native libraries mapped in process ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({ln.split()[-1] for ln in f
                       if "/libgpunode-" in ln or "/libtpusched-" in ln})


def phase_operator_image(workdir: str, card: dict) -> dict:
    """The card composed by the port's operator image (docstring, phase
    2b): ``Dockerfile.torch`` replayed into ``workdir`` and made
    read-only, the node-agent daemon and one operator replica started
    from that tree alone with no compiler on PATH, one H100 request
    Running, both native libraries mapped from the tree."""
    import signal
    import urllib.request
    from types import SimpleNamespace

    from tpu_composer_torch import API_VERSION
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposableResource, image)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.fleet.proc import ProcFleet
    from tpu_composer_torch.runtime.kubestore import (
        CHIP_RESOURCE, KubeConfig, KubeStore)
    from tpu_composer_torch.sim.apiserver import core_node_doc

    ms = {}
    t0 = time.perf_counter()
    lay = image.build_layout(os.path.join(HERE, "Dockerfile.torch"),
                             os.path.join(workdir, "image"))
    ms["layout"] = (time.perf_counter() - t0) * 1e3
    image.freeze(lay.final.root)
    before = image.listing(lay.final.root)
    env = image.image_env(lay)
    compilers = {c: shutil.which(c, path=env["PATH"])
                 for c in ("c++", "g++", "cc", "nvcc")}
    check(not any(compilers.values()),
          f"operator_image: a compiler on the image's PATH {compilers}")
    pkg = lay.final.path("tpu_composer_torch")
    libs = sorted(os.listdir(os.path.join(pkg, "build")))
    check([lib.split("-")[0] for lib in libs] == ["libgpunode", "libtpusched"],
          f"operator_image: the image's build/ holds {libs}")
    want = {lib.split("-")[0]: os.path.join(pkg, "build", lib) for lib in libs}

    torch.ones(1, device=DEVICE)  # this process's context holds the card
    cuda_nodes = _cuda_nodes()
    check(len(cuda_nodes) == 1,
          f"operator_image: this process holds {cuda_nodes}")
    root = os.path.join(workdir, "run")
    agent_dirs = {k: os.path.join(root, "agent", k)
                  for k in ("cdi", "state", "plugins")}
    agent_addr = f"127.0.0.1:{_free_port()}"
    agent_log_path = os.path.join(workdir, "agent.log")
    os.makedirs(root)
    agent_log = open(agent_log_path, "wb")
    t0 = time.perf_counter()
    agent_proc = subprocess.Popen(
        _agent_argv(agent_addr, agent_dirs), stdout=agent_log,
        stderr=subprocess.STDOUT, cwd=root,
        env=dict(image.runtime_env(lay), NODE_NAME="localhost"))
    fleet = None
    obs = None
    try:
        def agent_up():
            try:
                with urllib.request.urlopen(f"http://{agent_addr}/healthz",
                                            timeout=1) as resp:
                    return resp.status == 200
            except OSError:
                check(agent_proc.poll() is None,
                      f"operator_image: the node agent exited"
                      f" {agent_proc.returncode}: {_tail(agent_log_path)}")
                return False

        check(_wait(agent_up, 60.0, 0.02),
              "operator_image: the node agent never answered /healthz")
        ms["agent_ready"] = (time.perf_counter() - t0) * 1e3
        check(f"(native library {want['libgpunode']})"
              in _tail(agent_log_path),
              f"operator_image: the node agent did not load"
              f" {want['libgpunode']}: {_tail(agent_log_path)}")

        fleet = ProcFleet(
            os.path.join(root, "fleet"), nodes=0, shards=1,
            expected_replicas=1, workers=2, pool_chips={H100_MODEL: 1},
            extra_env=dict(env, **BINARY_ENV,
                           NODE_AGENT_ENDPOINT_TEMPLATE=agent_addr))
        fleet.apiserver.put_object("/api/v1/nodes", core_node_doc(
            "localhost", chips=1, chip_resource=CHIP_RESOURCE))
        t0 = time.perf_counter()
        rep = fleet.spawn(IMAGE_REPLICA, wait_ready_s=60.0)
        ms["replica_ready"] = (time.perf_counter() - t0) * 1e3

        url = fleet.apiserver.url
        obs = KubeStore(KubeConfig(host=url), cache_reads=False,
                        wire_mux=False)
        name = "chip-smoke-image"
        code, _, ms["submit_post"] = _post_json(url + fleet.cr_prefix, {
            "apiVersion": API_VERSION,
            "kind": "ComposabilityRequest", "metadata": {"name": name},
            "spec": {"resource": {"type": "gpu", "model": H100_MODEL,
                                  "size": 1}}})
        t_submit = time.perf_counter()
        check(code == 201, f"operator_image: the apiserver answered {code}")

        def running():
            kids = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
            return (obs.get(ComposabilityRequest, name).status.state
                    == "Running" and len(kids) == 1
                    and kids[0].status.state == "Online")

        check(_wait(running, IMAGE_RUNNING_S, 0.005),
              f"operator_image: the request was not Running within"
              f" {IMAGE_RUNNING_S} s: {fleet.tail_log(IMAGE_REPLICA)}")
        ms["submit_to_running"] = (time.perf_counter() - t_submit) * 1e3
        req = obs.get(ComposabilityRequest, name)
        (child,) = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
        spec = _ha_spec(SimpleNamespace(cdi_dir=agent_dirs["cdi"]),
                        f"{name}-slice", child, req, "operator_image")

        maps = {"agent": _mapped_native(agent_proc.pid),
                "replica": _mapped_native(rep.pid)}
        check(maps == {"agent": [want["libgpunode"]],
                       "replica": [want["libtpusched"]]},
              f"operator_image: the children mapped {maps}, not the"
              f" image's {want}")

        fleet.drain(IMAGE_REPLICA)
        agent_proc.send_signal(signal.SIGTERM)
        rcs = {"replica": rep.proc.returncode,
               "agent": agent_proc.wait(timeout=30)}
        check(rcs == {"replica": 0, "agent": 0},
              f"operator_image: exit codes {rcs}")
        check(image.listing(lay.final.root) == before,
              "operator_image: a process wrote into the image's tree")
    finally:
        if obs is not None:
            obs.close()
        if fleet is not None:
            fleet.close()
        if agent_proc.poll() is None:
            agent_proc.kill()
            agent_proc.wait(timeout=10)
        agent_log.close()
        image.thaw(lay.final.root)
    rec = {"card": card["nvidia_smi"], "host_ms": ms,
           "entrypoint": lay.final.entrypoint, "user": lay.final.user,
           "pip": lay.final.installs.get("pip", []),
           "libraries": [os.path.relpath(p, workdir) for p in
                         sorted(want.values())],
           "request": name, "slice": req.status.slice.to_dict(),
           "device_ids": list(child.status.device_ids),
           "spec": {k: v for k, v in spec.items() if k != "env"},
           "exit_codes": rcs}
    emit("operator_image", **rec)
    return rec


TRAIN_SHAPE = (8, 512, 8, 2, 64)  # B, S, H, KV, D of the training path
QUALIFY_SHAPE = (8, 512, 8, 8, 64)  # qualify_slice's default model: MHA


def _attn_inputs(gen, shape, dtype):
    b, s, h, kv, d = shape
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    do = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    return q, k, v, do


def _attn_bounds(shape, dtype, causal: bool = True) -> dict:
    """Bytes and operations of K1 (without and with lse), B3 and B4 on
    ``shape``: each input read once, each output written once; 2·D
    operations per (q, k) pair per product (2 in K1, 3 in B3, 4 in B4),
    live pairs only."""
    b, s, h, kv, d = shape
    e = torch.tensor([], dtype=dtype).element_size()
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes, row_bytes = b * s * h * d * e, b * s * kv * d * e, \
        b * h * s * 4
    work = {
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes, 2),
        "flash_fwd_lse": (2 * q_bytes + 2 * kv_bytes + row_bytes, 2),
        "flash_bwd_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 3),
        "flash_bwd_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 4),
    }
    out = {}
    for name, (n_bytes, products) in work.items():
        ms, by = bound_ms(n_bytes, products * 2 * d * pairs, dtype)
        out[name] = {"bound_ms": ms, "bound_by": by, "bytes": n_bytes,
                     "operations": products * 2 * d * pairs}
    return out


def phase_flash(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.attention import (
        _fwd_rows,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    h, kv, d = 8, 2, 64
    errs = {}
    # The flagship's head_dim 64 at every shape, and the kernel's other
    # head_dim, 128, at one ragged length; bf16 at both CTA heights.
    shapes = [(b, s, d) for b in (1, 2) for s in (8, 64, 256, 512)]
    shapes.append((1, 100, 128))
    for dtype in (torch.float32, torch.bfloat16):
        worst = worst_lse = worst_with_lse = 0.0
        geometries = (16, 64) if dtype == torch.bfloat16 else (None,)
        for b, s, dd in shapes:
            q = torch.randn(b, s, h, dd, generator=gen).to("cuda", dtype)
            k = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            v = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            for causal in (False, True):
                for with_lse in (False, True):
                    want, lse_w = flash_fwd_plain(q, k, v, causal,
                                                  with_lse)
                    for rows in geometries:
                        got, lse = flash_fwd_cuda(q, k, v, causal, with_lse,
                                                  rows=rows)
                        torch.cuda.synchronize()
                        err = max_err(got, want)
                        worst = max(worst, err)
                        if with_lse:
                            worst_with_lse = max(worst_with_lse, err)
                            worst_lse = max(worst_lse, max_err(lse, lse_w))
        name = str(dtype).replace("torch.", "")
        errs[name] = {"out": worst, "lse": worst_lse,
                      "out_with_lse": worst_with_lse}
        check(worst <= TOL[dtype], f"flash_fwd {name} error {worst}")
        check(worst_lse <= LSE_TOL, f"flash_fwd {name} lse error {worst_lse}")

    # The serving prefill shape: one prompt padded to its 256 bucket.
    b, s, dtype = 1, 256, torch.bfloat16
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = _fwd_rows(b, h, s)
    timing = {
        "shape": [b, s, h, kv, d], "dtype": "bfloat16", "causal": True,
        "rows": rows, "ctas": b * h * -(-s // rows),
        **timings(lambda: flash_fwd_cuda(q, k, v, True),
                  lambda: flash_fwd_plain(q, k, v, True),
                  lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    # Both CTA heights at this shape, device time and issue time.
    timing["by_rows"] = {
        str(r): dict(zip(("ms", "issue_ms"), timed(
            lambda r=r: flash_fwd_cuda(q, k, v, True, rows=r))))
        for r in (16, 64)}
    bound = _attn_bounds((b, s, h, kv, d), dtype)["flash_fwd"]
    timing["bound_ms"], timing["bound_by"] = bound["bound_ms"], \
        bound["bound_by"]
    timing["max_abs_err"] = errs["bfloat16"]["out"]
    emit("flash_fwd", errors=errs, tol={"fp32": 1e-4, "bf16": 2e-2,
                                       "lse": LSE_TOL}, **timing)
    return timing


def _paged_inputs(gen: torch.Generator, dtype, quant: bool, dh: int = 64,
                  max_len: int = 512, full: bool = False, kv: int = 2,
                  h: int = 8, bs: int = 16, mb: int = 32, lengths=None):
    """Engine decode shape: 8 rows over a pool of 8·``mb`` blocks of
    ``bs`` positions (default 256 blocks of 16), ``mb`` table slots per
    row, ``h`` query heads over ``kv`` KV heads (8 over 2 for the dense
    flagship, 8 over 8 for the MHA MoE flagship). Row 0 has length 0; the
    rest draw lengths in 1..max_len; with ``full`` every row has length
    mb·bs; ``lengths`` (8 of them) sets them instead. Owned slots hold
    distinct ids; the slots past each row's blocks hold stale ids that
    may name other rows' blocks."""
    from tpu_composer_torch.models.decode import quantize_kv

    b = 8
    n = b * mb
    if lengths is not None:
        lengths = torch.as_tensor(lengths)
    elif full:
        lengths = torch.full((b,), mb * bs)
    else:
        lengths = torch.randint(1, max_len + 1, (b,), generator=gen)
        lengths[0] = 0
    owned = -(-lengths // bs)
    perm = torch.randperm(n, generator=gen)
    tables = torch.randint(0, n, (b, mb), generator=gen)
    used = 0
    for r in range(b):
        # 8 rows x <= mb blocks: the pool covers every row.
        tables[r, :owned[r]] = perm[used:used + owned[r]]
        used += int(owned[r])
    q = torch.randn(b, h, dh, generator=gen)
    kf = torch.randn(n, bs, kv, dh, generator=gen)
    vf = torch.randn(n, bs, kv, dh, generator=gen)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        scales = (ks.cuda(), vs.cuda())
    else:
        kp, vp, scales = kf.to(dtype), vf.to(dtype), (None, None)
    return (q.to("cuda", dtype), kp.cuda(), vp.cuda(),
            tables.to("cuda", torch.int32), lengths.to("cuda", torch.int32),
            *scales)


def _paged_bound(args) -> tuple:
    q, kp, vp, tables, lengths, ks, vs = args
    bs, mb = kp.shape[1], tables.shape[1]
    live = lengths.clamp(max=mb * bs).long()
    positions = int(live.sum())
    per_pos = kp.shape[2] * kp.shape[3] * kp.element_size() * 2  # K and V
    if ks is not None:
        per_pos += kp.shape[2] * 4 * 2
    n_bytes = (2 * q.numel() * q.element_size() + positions * per_pos
               + int((-(-live // bs)).sum()) * 4 + lengths.numel() * 4)
    n_ops = 4 * q.shape[1] * q.shape[2] * positions
    return bound_ms(n_bytes, n_ops, kp.dtype)


def phase_paged(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.paged_attention import (
        _decode_split,
        paged_decode_cuda,
        paged_decode_plain,
    )

    # The flagship's head_dim 64, and the kernel's other head_dim, 128;
    # random lengths (0..512), then full rows and rows inside one chunk.
    cases = {"fp32": (torch.float32, False, 64, {}),
             "bf16": (torch.bfloat16, False, 64, {}),
             "int8_q_fp32": (torch.float32, True, 64, {}),
             "int8_q_bf16": (torch.bfloat16, True, 64, {}),
             "bf16_dh128": (torch.bfloat16, False, 128, {}),
             "int8_q_fp32_dh128": (torch.float32, True, 128, {}),
             "bf16_full": (torch.bfloat16, False, 64, {"full": True}),
             "int8_q_fp32_full": (torch.float32, True, 64, {"full": True}),
             "fp32_one_chunk": (torch.float32, False, 64, {"max_len": 64}),
             "bf16_one_chunk": (torch.bfloat16, False, 64, {"max_len": 64}),
             # The MoE engine's shape: MHA, G = 1, lengths 0..320.
             "fp32_mha": (torch.float32, False, 64, {"kv": 8, "max_len": 320}),
             "bf16_mha": (torch.bfloat16, False, 64,
                          {"kv": 8, "max_len": 320}),
             "int8_q_bf16_mha": (torch.bfloat16, True, 64,
                                 {"kv": 8, "max_len": 320})}
    errs, timing = {}, {}
    for name, (dtype, quant, dh, kw) in cases.items():
        worst = 0.0
        for _ in range(3):
            args = _paged_inputs(gen, dtype, quant, dh, **kw)
            got = paged_decode_cuda(*args)
            want = paged_decode_plain(*args)
            torch.cuda.synchronize()
            if not kw.get("full"):
                check(bool((got[0] == 0).all()),
                      f"paged {name}: 0-length row")
            worst = max(worst, max_err(got, want))
        errs[name] = worst
        check(worst <= TOL[dtype], f"paged_decode {name} error {worst}")
        # Two launches on the same inputs: the same bits (the partials
        # merge in a fixed order, no atomics).
        again = paged_decode_cuda(*args)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.uint8), again.view(torch.uint8)),
              f"paged_decode {name}: two launches differ")
        if name in ("bf16", "int8_q_bf16", "bf16_mha", "int8_q_bf16_mha"):
            t = {**timings(lambda: paged_decode_cuda(*args),
                           lambda: paged_decode_plain(*args)),
                 "max_abs_err": worst, "lengths": args[4].tolist()}
            t["bound_ms"], t["bound_by"] = _paged_bound(args)
            timing[name] = t
    b, kv, bs, mb = 8, 2, 16, 32
    chunk, n_split = _decode_split(bs, mb)
    emit("paged_decode", errors=errs,
         tol={"fp32": 1e-4, "bf16": 2e-2}, shape=[8, 8, 2, 64, 16, 32, 256],
         mha_shape=[8, 8, 8, 64, 16, 32, 256],
         geometry={"chunk": chunk, "n_split": n_split,
                   "split_ctas": b * kv * n_split,
                   "split_ctas_mha": b * 8 * n_split},
         bitwise_repeatable=True, timing=timing)
    return timing


def _bwd_errors(got, want, dtype, case: str, worst: dict) -> None:
    """Check each of dq, dk, dv of one case against its plain value,
    relative to that gradient's own max|ref|, and keep in ``worst`` the
    worst case of each gradient with its error and scale, and the
    smallest scale seen."""
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err, scale = max_err(a, w), float(w.float().abs().max())
        check(0 < scale and err <= BWD_TOL[dtype] * scale,
              f"flash_bwd {case} {name}: error {err} against max|ref|"
              f" {scale} (tolerance {BWD_TOL[dtype]} x max|ref|)")
        least = min(scale, worst.get(name, {}).get("least_max_ref", scale))
        if name not in worst or err / scale > worst[name]["relative"]:
            worst[name] = {"relative": err / scale, "abs": err,
                           "max_ref": scale, "case": case}
        worst[name]["least_max_ref"] = least


def phase_flash_bwd(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.attention import (
        _delta,
        _dkv_split,
        _fwd_rows,
        flash_bwd_cuda,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_plain,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    h = 8
    shapes = [(b, s, 64) for b in (1, 2) for s in (8, 64, 256, 512)]
    shapes.append((1, 100, 128))  # ragged length, the other head_dim
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst: dict = {}
        for b, s, d in shapes:
            for kv in (2, 8):
                q, k, v, do = _attn_inputs(gen, (b, s, h, kv, d), dtype)
                for causal in (False, True):
                    out, lse = flash_fwd_cuda(q, k, v, causal, with_lse=True)
                    for with_g in (False, True):
                        g_lse = (torch.randn(b, h, s, generator=gen).cuda()
                                 if with_g else None)
                        got = flash_bwd_cuda(q, k, v, out, lse, do, g_lse,
                                             causal)
                        torch.cuda.synchronize()
                        want = flash_bwd_plain(q, k, v, out, lse, do, g_lse,
                                               causal)
                        case = (f"B{b} S{s} D{d} KV{kv} causal={causal}"
                                f" g_lse={with_g}")
                        _bwd_errors(got, want, dtype, case, worst)
                        if dtype == torch.bfloat16 and kv < h:
                            # B4 with its GQA group in one CTA too (the
                            # default splits it at these sizes).
                            delta = _delta(out, do, g_lse)
                            one = flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                     causal, split=1)
                            torch.cuda.synchronize()
                            _bwd_errors((got[0], *one), want, dtype,
                                        case + " split=1", worst)
        errs[str(dtype).replace("torch.", "")] = worst

    # The path's own inputs: the train step's GQA shape and qualify_slice's
    # MHA shape, bf16, causal, no lse cotangent. K1 with lse against its
    # plain version, then B3 and B4 on K1's out and lse.
    dtype = torch.bfloat16
    path = {}
    for label, shape in (("qualify", QUALIFY_SHAPE), ("train", TRAIN_SHAPE)):
        q, k, v, do = _attn_inputs(gen, shape, dtype)
        out, lse = flash_fwd_cuda(q, k, v, True, with_lse=True)
        out_w, lse_w = flash_fwd_plain(q, k, v, True, with_lse=True)
        got = flash_bwd_cuda(q, k, v, out, lse, do, None, True)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, out_w), max_err(lse, lse_w)
        check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
        check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse error {e_lse}")
        worst = {}
        _bwd_errors(got, flash_bwd_plain(q, k, v, out, lse, do, None, True),
                    dtype, f"{label} {list(shape)}", worst)
        path[label] = {"shape": list(shape), "out": e_out, "lse": e_lse,
                       **worst}
    errs["bfloat16_path"] = path

    # B3 and B4 twice on the training-shape inputs: the same bits (each
    # B3 CTA owns its dQ rows; B4's split partials are summed in a fixed
    # order; no atomics).
    delta = _delta(out, do)
    b, s, h, kv, d = shape
    split = _dkv_split(b, kv, h // kv, s)
    twice = [flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
             for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(twice[0].view(torch.int16), twice[1].view(torch.int16)),
          "flash_bwd_dq: two launches on the same inputs differ")
    twice = [flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
             for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int16), y.view(torch.int16))
              for x, y in zip(*twice)),
          "flash_bwd_dkv: two launches on the same inputs differ")

    # Times at the training shape, on the inputs left by the loop above.
    # The library yardsticks, timed only: SDPA's forward, and SDPA's
    # backward on one recorded forward.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    recorded = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(recorded, (qt, kt, vt), dot,
                                   retain_graph=True)

    # The plain backward computes dq, dk and dv (and δ) in one pass, and
    # SDPA's backward all three: both kernel rows carry their times.
    def plain_bwd():
        return flash_bwd_plain(q, k, v, out, lse, do, None, True)

    timing = {
        "flash_fwd_lse": timings(
            lambda: flash_fwd_cuda(q, k, v, True, True),
            lambda: flash_fwd_plain(q, k, v, True, True), sdpa_fwd),
        "flash_bwd_dq": timings(
            lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
            plain_bwd, sdpa_bwd),
        "flash_bwd_dkv": timings(
            lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True),
            plain_bwd, sdpa_bwd),
    }
    bounds = _attn_bounds(shape, dtype)
    for name in timing:
        timing[name].update(bounds[name])
    # The kernels rows carry the errors on the path's own inputs.
    runs = path.values()
    timing["flash_fwd_lse"]["max_abs_err"] = max(r["out"] for r in runs)
    timing["flash_bwd_dq"]["max_abs_err"] = max(r["dq"]["abs"] for r in runs)
    timing["flash_bwd_dkv"]["max_abs_err"] = max(
        r[g]["abs"] for r in runs for g in ("dk", "dv"))

    # The multi-rank training path's blocks (phase mesh_train's run,
    # bf16): a ring block of sp = 2 at seq 512 (the causal diagonal and a
    # whole off-diagonal block, each with the lse cotangent the ring's
    # merge sends) and Ulysses' gathered sequence over half the heads.
    mesh_path = {}
    for label, mshape, causal, with_g in (
            ("ring_diagonal", (8, 256, 8, 2, 64), True, True),
            ("ring_offdiagonal", (8, 256, 8, 2, 64), False, True),
            ("ulysses", (8, 512, 4, 1, 64), True, False)):
        q, k, v, do = _attn_inputs(gen, mshape, dtype)
        out, lse = flash_fwd_cuda(q, k, v, causal, with_lse=True)
        out_w, lse_w = flash_fwd_plain(q, k, v, causal, with_lse=True)
        g_lse = (torch.randn(mshape[0], mshape[2], mshape[1],
                             generator=gen).cuda() if with_g else None)
        got = flash_bwd_cuda(q, k, v, out, lse, do, g_lse, causal)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, out_w), max_err(lse, lse_w)
        check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
        check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse error {e_lse}")
        worst = {}
        _bwd_errors(got, flash_bwd_plain(q, k, v, out, lse, do, g_lse,
                                         causal),
                    dtype, f"{label} {list(mshape)}", worst)
        bq, sq, hq, kvq, _ = mshape
        mesh_path[label] = {
            "shape": list(mshape), "causal": causal, "g_lse": with_g,
            "out": e_out, "lse": e_lse, **worst,
            "flash_fwd_rows": _fwd_rows(bq, hq, sq),
            "flash_bwd_dkv_split": _dkv_split(bq, kvq, hq // kvq, sq)}
    errs["bfloat16_mesh_path"] = mesh_path
    rows = _fwd_rows(b, h, s)
    emit("flash_bwd", errors=errs, tol={"fp32": 1e-4, "bf16": 3e-2,
                                        "relative_to": "max|ref| per gradient",
                                        "flash_fwd_lse": [TOL[dtype], LSE_TOL]},
         shape=list(shape), dtype="bfloat16", causal=True,
         geometry={"flash_fwd_rows": rows,
                   "flash_fwd_ctas": b * h * -(-s // rows),
                   "flash_bwd_dq_ctas": b * h * -(-s // 64),
                   "flash_bwd_dkv_split": split,
                   "flash_bwd_dkv_ctas": b * kv * -(-s // 64) * split},
         dq_bitwise_repeatable=True, dkv_bitwise_repeatable=True,
         timing=timing)
    return timing


FLAGSHIP = dict(vocab_size=8192, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=2, d_ff=1408, max_seq=512)


# The full-width MoE flagship: MoEConfig()'s defaults, bf16 and a fp32
# router unless a phase says otherwise.
MOE_FLAGSHIP = dict(vocab_size=32000, d_model=512, n_layers=4, n_heads=8,
                    d_ff=1408, max_seq=2048, n_experts=8, top_k=2,
                    capacity_factor=1.25, moe_period=2)
DEVICE = "cuda"


def _counts() -> dict:
    """Every kernel wrapper's launch count, by kernel row."""
    from tpu_composer_torch.workload.probe import kernel_launches

    return kernel_launches()


def _set_counts(counts: dict) -> None:
    """Set every kernel wrapper's launch count (``_counts``' keys)."""
    from tpu_composer_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    flash_fwd_cuda.launches = counts["flash_fwd"]
    flash_fwd_cuda.launches_lse = counts["flash_fwd_lse"]
    flash_bwd_dq_cuda.launches = counts["flash_bwd_dq"]
    flash_bwd_dkv_cuda.launches = counts["flash_bwd_dkv"]
    paged_decode_cuda.launches = counts["paged_decode"]
    paged_decode_cuda.launches_int8 = counts["paged_decode_int8"]


def _reset_counts() -> None:
    _set_counts(dict.fromkeys(_counts(), 0))


class _uncounted:
    """Launches inside this block are put back out of the counts: the
    comparisons of a kernel with its plain version do not count toward a
    path's launches."""

    def __enter__(self):
        self.saved = _counts()

    def __exit__(self, *exc):
        _set_counts(self.saved)
        return False


def _k2_against_gather(eng) -> dict:
    """One mid-flight decode step of ``eng`` through K2 and through the
    gather path, each on its own copy of the engine's cache (the engine
    itself does not move): the live rows' logits and their distance."""
    from tpu_composer_torch.models.paged import paged_decode_step

    admitting = {st["slot"] for st in eng._admitting}
    active = np.array([r is not None and s not in admitting
                       for s, r in enumerate(eng._slot_req)], bool)
    token = torch.as_tensor(eng._next_token, device=eng.device)
    lengths = eng.cache.length.cpu().numpy()[active]
    logits = {}
    with _uncounted():
        for impl in ("kernel", "gather"):
            cache = eng.cache._replace(**{
                f: v.clone() for f, v in eng.cache._asdict().items()
                if torch.is_tensor(v)})
            out, _, ok = paged_decode_step(eng.params, cache, token,
                                           eng.config, attn_impl=impl,
                                           active=active)
            check(bool(ok), "K2 check: the pool copy ran out of blocks")
            logits[impl] = out[torch.from_numpy(active).to(out.device)]
    return {"rows": int(active.sum()), "lengths": lengths.tolist(),
            "err": max_err(logits["kernel"], logits["gather"])}


def _launched(before: dict, kernels) -> dict:
    """Launches of ``kernels`` since the counts ``before``."""
    after = _counts()
    return {k: after[k] - before[k] for k in kernels}


def phase_serve_exact(rng: np.random.Generator, seed: int) -> dict:
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device="cuda")
    before = _counts()
    eng = ContinuousBatchingEngine(params, cfg, slots=4, num_blocks=128,
                                   block_size=16, blocks_per_row=32,
                                   attn_impl="kernel")
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 64, 131, 256)]
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run()
    launches = _launched(before, ("flash_fwd", "paged_decode"))
    for req, p in zip(reqs, prompts):
        solo = generate(params, torch.tensor([p], device="cuda"), ref,
                        max_new_tokens=24)[0].tolist()
        check(req.tokens == solo,
              f"serve_exact request {req.req_id} diverged from its solo run")
    check(all(n > 0 for n in launches.values()),
          f"serve_exact did not launch every kernel: {launches}")
    check(int(eng.cache.free_top) == 128, "serve_exact pool did not drain")
    emit("serve_exact", requests=len(reqs), tokens_equal=True,
         launches=launches)
    return launches


def _make_recording_engine():
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine

    class RecordingEngine(ContinuousBatchingEngine):
        """Keeps each request's first-token logits for the plain check."""

        first_logits: dict

        def _pick_first(self, slot, logits_1v):
            self.first_logits[self._slot_req[slot].req_id] = (
                logits_1v[0].float().cpu())
            return super()._pick_first(slot, logits_1v)

    return RecordingEngine


def _submit_all(eng, rng, vocab: int, seed: int, new_tokens: int,
                prefix=None) -> list:
    """16 requests of 16-256 tokens (the even ones after ``prefix`` when
    given), the odd ones sampled (temperature 0.8, top-k 50, top-p
    0.95)."""
    reqs = []
    for i in range(16):
        n = int(rng.integers(16, 257))
        prompt = rng.integers(0, vocab, n).tolist()
        if prefix is not None and i % 2 == 0:
            prompt = prefix.tokens + prompt
            kw = {"prefix": prefix}
        else:
            kw = {}
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95, seed=seed + i)
        reqs.append(eng.submit(prompt, new_tokens, **kw))
    return reqs


def _drive(eng) -> dict:
    """Run the engine to completion, timing every step on the host clock
    (each step ends in a host read of the picked tokens). At the first
    decode-only step after the 10th with two rows or more in flight, K2
    is held against the gather path (untimed: ``k2_midflight``)."""
    steps, decode_only = [], []
    k2 = None
    t0 = time.perf_counter()
    while eng._waiting or any(r is not None for r in eng._slot_req):
        quiet = not eng._waiting and not eng._admitting
        if (k2 is None and quiet and len(steps) >= 10
                and sum(r is not None for r in eng._slot_req) >= 2):
            t_check = time.perf_counter()
            k2 = _k2_against_gather(eng)
            t0 += time.perf_counter() - t_check
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - s0) * 1e3
        steps.append(dt)
        if quiet:
            decode_only.append(dt)
    wall = time.perf_counter() - t0
    check(k2 is not None, "no decode step was in flight for the K2 check")
    return {"wall_s": wall, "steps": len(steps), "k2_midflight": k2,
            "step_ms_p50": float(np.median(steps)),
            "decode_step_ms_p50": (float(np.median(decode_only))
                                   if decode_only else None)}


def _device_share(step, n_steps: int = 8, ranges=()) -> dict:
    """Device busy share over a few calls of ``step`` (torch.profiler):
    summed kernel time over host wall time, and the kernels that take
    it; for each ``record_function`` range named in ``ranges``, its host
    time and the device time of the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # A range shows on the device too (as an annotation spanning its
    # kernels and the gaps between them): kernels only here.
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in events if any(
        n in e.key for n in ("flash_fwd", "flash_bwd", "dkv_reduce",
                             "paged_decode"))]
    return {"steps": n_steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "kernel_launches": sum(e.count for e in events),
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top],
            "port_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in ours],
            "ranges": {e.key: {"host_ms": e.cpu_time_total / 1e3,
                               "device_ms": e.device_time_total / 1e3,
                               "calls": e.count}
                       for e in averages if e.key in ranges
                       and e.device_type == torch.autograd.DeviceType.CPU}}


def phase_serve(rng: np.random.Generator, seed: int) -> dict:
    from tpu_composer_torch.models.decode import prefill
    from tpu_composer_torch.models.serving import _bucket
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device="cuda")
    Engine = _make_recording_engine()
    new_tokens = 64

    def plain_first_logits(prompt):
        pad = _bucket(len(prompt))
        toks = torch.zeros((1, pad), dtype=torch.long, device="cuda")
        toks[0, :len(prompt)] = torch.tensor(prompt)
        logits, _ = prefill(params, toks, ref, prompt_lens=[len(prompt)])
        return logits[0].float().cpu()

    def submit_all(eng, prefix=None):
        return _submit_all(eng, rng, cfg.vocab_size, seed, new_tokens, prefix)

    results = {}
    # Engine A: bucketed admission (prefill through K1), bf16 pool (K2).
    before = _counts()
    eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                 blocks_per_row=32, attn_impl="kernel")
    eng.first_logits = {}
    reqs = submit_all(eng)
    stats = _drive(eng)
    launches = _launched(before, ("flash_fwd", "paged_decode"))
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "bf16 engine left a request unfinished")
    check(int(eng.cache.free_top) == 256, "bf16 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"bf16 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_BF16, f"bf16 first-token logits off by {worst}")
    check(stats["k2_midflight"]["err"] <= LOGIT_TOL_BF16,
          f"bf16 engine: K2 mid-flight logits off the gather path by"
          f" {stats['k2_midflight']['err']}")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    results["bf16"] = dict(stats, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / stats["wall_s"],
                           launches=launches, first_logit_err=worst)
    emit("serve", engine="bf16", **results["bf16"])

    # The device's share of a decode step: 8 requests decoding in 8 slots.
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 128).tolist(), 64)
    while eng._waiting:
        eng.step()  # one admission per step
    results["profile"] = _device_share(eng.step)
    emit("serve_profile", **results["profile"])
    eng.run()

    # Engine B: int8 pool (K2 int8), chunked admission, a shared prefix
    # (registered through a bucketed prefill, so K1 too).
    before = _counts()
    eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                 blocks_per_row=32, attn_impl="kernel", kv_quant=True,
                 prefill_chunk=64)
    eng.first_logits = {}
    handle = eng.register_prefix(rng.integers(0, cfg.vocab_size, 64).tolist())
    reqs = submit_all(eng, prefix=handle)
    stats = _drive(eng)
    launches = _launched(before, ("flash_fwd", "paged_decode_int8"))
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "int8 engine left a request unfinished")
    eng.close_prefix(handle)
    check(int(eng.cache.free_top) == 256, "int8 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"int8 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_INT8, f"int8 first-token logits off by {worst}")
    check(stats["k2_midflight"]["err"] <= LOGIT_TOL_INT8,
          f"int8 engine: K2 mid-flight logits off the gather path by"
          f" {stats['k2_midflight']['err']}")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    results["int8"] = dict(stats, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / stats["wall_s"],
                           launches=launches, first_logit_err=worst)
    emit("serve", engine="int8_chunked_prefix", **results["int8"])
    return results


def _grads(params, tokens, cfg):
    from tpu_composer_torch.models.transformer import loss_fn
    from tpu_composer_torch.parallel.train import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    return torch.autograd.grad(loss_fn(live, tokens, cfg), tree_leaves(live))


def phase_train_exact(seed: int) -> dict:
    """fp32 flagship: flash attention (K1 with lse, B3, B4) against
    reference attention through 3 train steps from the same params."""
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, FLAGSHIP["vocab_size"], (4, 256),
                             generator=gen, dtype=torch.int32).cuda()
               for _ in range(3)]
    runs = {}
    for impl in ("flash", "reference"):
        cfg = ModelConfig(dtype=torch.float32, attn_impl=impl, **FLAGSHIP)
        tc = TrainConfig(model=cfg)
        state = make_train_state(tc, seed, "cuda")
        grads = _grads(state["params"], batches[0], cfg)
        step = make_train_step(tc)
        metrics = []
        for toks in batches:
            state, m = step(state, toks)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[impl] = (grads, metrics)
    (g_f, m_f), (g_r, m_r) = runs["flash"], runs["reference"]
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(m_f, m_r))
    norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(m_f, m_r))
    grad_err = max(max_err(a, b) / max(1.0, float(b.abs().max()))
                   for a, b in zip(g_f, g_r))
    check(loss_err <= 1e-4, f"train_exact losses differ by {loss_err}")
    check(norm_err <= 1e-3, f"train_exact grad norms differ by {norm_err}")
    check(grad_err <= 1e-4, f"train_exact gradients differ by {grad_err}")
    out = {"losses_flash": [m["loss"] for m in m_f],
           "losses_reference": [m["loss"] for m in m_r],
           "grad_norms_flash": [m["grad_norm"] for m in m_f],
           "max_loss_err": loss_err, "max_grad_norm_rel_err": norm_err,
           "max_grad_rel_err": grad_err}
    emit("train_exact", tokens=[4, 256], steps=3, **out)
    # The one-process flash step is the mesh phase's reference.
    out["ref_grads"] = [g.cpu() for g in g_f]
    return out


def phase_train(seed: int) -> dict:
    """bf16 flagship through trainer.fit: 20 steps checkpointed every 10,
    then a resumed fit to 24; step timing, a step that must make no host
    sync, and the device's busy share."""
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import TrainConfig, make_train_step
    from tpu_composer_torch.workload.trainer import fit

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg)
    seq, batch = 512, 8
    docs = zipf_documents(seed, vocab=FLAGSHIP["vocab_size"])
    dataset = PackedLMDataset(docs, seq_len=seq, seed=seed)
    with tempfile.TemporaryDirectory() as cdir:
        t0 = time.perf_counter()
        first = fit(tc, dataset, total_steps=20, global_batch=batch,
                    checkpoint_dir=cdir, checkpoint_every=10, log_every=10,
                    seed=seed)
        fit_s = time.perf_counter() - t0
        second = fit(tc, dataset, total_steps=24, global_batch=batch,
                     checkpoint_dir=cdir, checkpoint_every=10, log_every=2,
                     seed=seed)
    losses = {int(r["step"]): r["loss"] for r in first.history}
    losses.update({int(r["step"]): r["loss"] for r in second.history})
    check(second.resumed_from == 20,
          f"train resumed from {second.resumed_from}, not 20")
    check(all(np.isfinite(v) for v in losses.values()),
          f"train losses not finite: {losses}")
    check(losses[20] < losses[10],
          f"train loss did not fall: {losses[10]} -> {losses[20]}")

    # Step time on the host clock, each step synchronised, from the
    # resumed state on the loader's next batches.
    state, step = second.state, make_train_step(tc)
    loader = ShardedLoader(dataset, batch, device="cuda", prefetch=False)
    loader.load_state_dict({"step": 24})
    batches = iter(loader)
    times = []
    for _ in range(8):
        toks = next(batches)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, _ = step(state, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - s0) * 1e3)
    p50 = float(np.median(times[2:]))
    toks = next(batches)
    # A step only queues work: any op in it that makes the host wait for
    # the card raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    profile = _device_share(lambda: step(state, toks), n_steps=3)
    tied_head = _tied_head_ab(lambda: step(state, toks))
    out = {"losses": losses, "resumed_from": second.resumed_from,
           "tied_head_device_ms_per_step": tied_head,
           "fit_20_steps_s": fit_s,
           "steps_per_s_logged": [r["steps_per_s"] for r in first.history],
           "step_ms_p50": p50, "step_ms": times, "host_syncs_in_step": 0,
           "tokens_per_s": batch * seq / (p50 / 1e3), "profile": profile}
    emit("train", seq=seq, global_batch=batch, **out)
    return out


def _tied_head_ab(step, n_steps: int = 3) -> dict:
    """Device ms of a train step with the tied head's two routes, in
    turns (upcast, bf16, bf16, upcast): the bf16 operands into an fp32
    output (``aten::mm.dtype``, the port's route on the card) and both
    operands upcast to fp32 first (the route before it)."""
    from tpu_composer_torch.models import transformer
    from tpu_composer_torch.models.quant import resolve

    def upcast(x, embed, dtype):
        return torch.einsum("...d,vd->...v", x.float(),
                            resolve(embed, dtype).float())

    route = transformer._tied_logits
    runs = {"bf16_mm_fp32_out": [], "fp32_upcast": []}
    try:
        for name in ("fp32_upcast", "bf16_mm_fp32_out", "bf16_mm_fp32_out",
                     "fp32_upcast"):
            transformer._tied_logits = upcast if name == "fp32_upcast" \
                else route
            prof = _device_share(step, n_steps=n_steps)
            runs[name].append(prof["device_busy_ms"] / n_steps)
    finally:
        transformer._tied_logits = route
    return runs


def phase_qualify() -> dict:
    from tpu_composer_torch.workload.acceptance import qualify_slice

    res = qualify_slice()
    emit("qualify", **res)
    check(res["attn_impl"] == "flash", f"qualify ran {res['attn_impl']}")
    check("attn_fallback" not in res, "qualify fell back")
    check(np.isfinite(res["train_loss"]), "qualify loss not finite")
    return res


def _first_divergence(got: list, want: list) -> int:
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def _top2_gap(params, cfg, seq: list) -> float:
    """The model's top-2 logit gap for the token after ``seq``."""
    from tpu_composer_torch.models.moe import forward

    with torch.no_grad():
        logits, _ = forward(params, torch.tensor([seq], device=DEVICE), cfg)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _check_tokens(label: str, got: list, want: list, params, cfg,
                  prompt: list) -> None:
    """Tokens equal, or fail naming the first diverging token and the
    target's top-2 logit gap there (under 1e-4: float drift between
    chunked and stepwise sums, not a logic fault)."""
    if got == want:
        return
    i = _first_divergence(got, want)
    gap = _top2_gap(params, cfg, prompt + want[:i])
    print(f"{label}: first diverging token {i}, target top-2 logit gap "
          f"{gap:.3e}", flush=True)
    check(False, f"{label} diverged from target-only greedy at token {i} "
                 f"(top-2 gap {gap:.3e})")


def _recording_routes(fn):
    """(``fn()``, the experts each routing call chose, (B, S, K) each):
    ``moe._route`` is patched for the call."""
    from tpu_composer_torch.models import moe

    route, seen = moe._route, []

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        seen.append(out[0])
        return out

    moe._route = recording
    try:
        return fn(), seen
    finally:
        moe._route = route


def _moved_choices(routes, other) -> int:
    """(token, layer) pairs whose set of chosen experts differs."""
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(routes, other))


def _moe_ffn_ranged():
    """Patch ``moe._moe_ffn`` to run inside a ``record_function`` range
    named "moe_ffn" (for a profile); returns the restore function."""
    from tpu_composer_torch.models import moe

    inner = moe._moe_ffn

    def ranged(*args, **kw):
        with torch.profiler.record_function("moe_ffn"):
            return inner(*args, **kw)

    moe._moe_ffn = ranged
    return lambda: setattr(moe, "_moe_ffn", inner)


def phase_moe_serve_exact(rng: np.random.Generator, seed: int) -> dict:
    """fp32 MoE flagship, capacity_factor 4.0: the engine (chunked
    admission, K2 decode) against each request's solo generate with
    reference attention."""
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.moe import MoEConfig, init_params
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine

    cfg = MoEConfig(dtype=torch.float32, attn_impl="flash",
                    **{**MOE_FLAGSHIP, "capacity_factor": 4.0})
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device=DEVICE)
    before = _counts()
    eng = ContinuousBatchingEngine(params, cfg, slots=4, num_blocks=128,
                                   block_size=16, blocks_per_row=32,
                                   attn_impl="kernel", prefill_chunk=64)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 64, 131, 256)]
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run()
    launches = _launched(before, ("paged_decode",))
    for req, p in zip(reqs, prompts):
        solo = generate(params, torch.tensor([p], device=DEVICE), ref,
                        max_new_tokens=24)[0].tolist()
        _check_tokens(f"moe_serve_exact request {req.req_id}", req.tokens,
                      solo, params, ref, p)
    check(launches["paged_decode"] > 0,
          f"moe_serve_exact did not launch K2: {launches}")
    check(int(eng.cache.free_top) == 128, "moe_serve_exact pool did not drain")
    emit("moe_serve_exact", requests=len(reqs), tokens_equal=True,
         launches=launches)
    return launches


def phase_moe_serve(rng: np.random.Generator, seed: int) -> dict:
    """bf16 MoE flagship through two chunked-admission engines with a
    shared prefix: a bf16 pool (K2 fp) and an int8 pool (K2 int8)."""
    from tpu_composer_torch.models.decode import decode_chunk, init_kv_cache
    from tpu_composer_torch.models.moe import MoEConfig, init_params

    cfg = MoEConfig(dtype=torch.bfloat16, attn_impl="flash", **MOE_FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device=DEVICE)
    Engine = _make_recording_engine()
    new_tokens = 64

    def plain_first_logits(req, kv_quant):
        # Drop-free routing, as the engine's chunks route: an empty dense
        # cache and decode_chunk over the prompt (not prefill, whose
        # capacity rule may drop tokens the chunks keep). The cache is as
        # long as an engine row and the chunks are the engine's (the
        # prefix, then 64 tokens at a time), so the sums run over the
        # same lengths: a router near-tie then resolves the same way.
        start = req.prefix.n_tokens if req.prefix is not None else 0
        cuts = ([0] if start else []) + list(range(start, len(req.prompt),
                                                   64)) + [len(req.prompt)]
        cache = init_kv_cache(ref, 1, max_seq=512, quant=kv_quant,
                              device=DEVICE)
        toks = torch.tensor([req.prompt], device=DEVICE)
        for a, b in zip(cuts, cuts[1:]):
            logits, cache = decode_chunk(params, cache, toks[:, a:b], ref)
        return logits[0, -1].float().cpu()

    results = {}
    for name, kv_quant, kernel, tol in (
            ("bf16", False, "paged_decode", LOGIT_TOL_BF16),
            ("int8", True, "paged_decode_int8", LOGIT_TOL_INT8)):
        before = _counts()
        eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                     blocks_per_row=32, attn_impl="kernel",
                     kv_quant=kv_quant, prefill_chunk=64)
        eng.first_logits = {}
        handle = eng.register_prefix(
            rng.integers(0, cfg.vocab_size, 64).tolist())
        reqs = _submit_all(eng, rng, cfg.vocab_size, seed, new_tokens,
                           prefix=handle)
        stats = _drive(eng)
        launches = _launched(before, (kernel,))
        check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
              f"MoE {name} engine left a request unfinished")
        eng.close_prefix(handle)
        check(int(eng.cache.free_top) == 256,
              f"MoE {name} engine pool did not drain")
        check(launches[kernel] > 0,
              f"MoE {name} engine did not launch {kernel}: {launches}")
        # The int8 pool is held to the plain path over an int8 dense
        # cache (the same quantized K/V). Beside it: its distance from an
        # fp cache, and how many (token, layer) routing choices the int8
        # K/V moved.
        plain = {r.req_id: _recording_routes(
            lambda r=r: plain_first_logits(r, kv_quant)) for r in reqs}
        worst = max(max_err(eng.first_logits[i], logits)
                    for i, (logits, _) in plain.items())
        check(worst <= tol, f"MoE {name} first-token logits off by {worst}")
        check(stats["k2_midflight"]["err"] <= tol,
              f"MoE {name} engine: K2 mid-flight logits off the gather"
              f" path by {stats['k2_midflight']['err']}")
        extra = {}
        if kv_quant:
            fp = {r.req_id: _recording_routes(
                lambda r=r: plain_first_logits(r, False)) for r in reqs}
            extra["first_logit_err_vs_fp_cache"] = max(
                max_err(eng.first_logits[i], fp[i][0]) for i in fp)
            extra["routing_moved_vs_fp_cache"] = sum(
                _moved_choices(plain[i][1], fp[i][1]) for i in fp)
            extra["routing_token_layers"] = sum(
                x.shape[0] * x.shape[1] for _, routes in plain.values()
                for x in routes)
        gen_tokens = sum(len(r.tokens) for r in reqs)
        results[name] = dict(stats, tokens=gen_tokens,
                             tokens_per_s=gen_tokens / stats["wall_s"],
                             launches=launches, first_logit_err=worst,
                             tol=tol, **extra)
        emit("moe_serve", engine=name, **results[name])
        if name != "bf16":
            continue
        # The device's share of a decode step, 8 requests in 8 slots, and
        # the MoE FFN's part of it.
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab_size, 128).tolist(), 64)
        while eng._waiting or eng._admitting:
            eng.step()
        restore = _moe_ffn_ranged()
        try:
            results["profile"] = _device_share(eng.step, ranges=("moe_ffn",))
        finally:
            restore()
        emit("moe_serve_profile", **results["profile"])
        eng.run()
    return results


def phase_speculative(rng: np.random.Generator, seed: int) -> dict:
    """fp32 MoE flagship (prefill through K1) verified against its
    int8-quantized self, dense and paged caches, against target-only
    greedy generate."""
    import warnings

    from tpu_composer_torch.models import speculative as spec
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.moe import MoEConfig, init_params
    from tpu_composer_torch.models.quant import quantize_decode_params

    cfg = MoEConfig(dtype=torch.float32, attn_impl="flash", **MOE_FLAGSHIP)
    params = init_params(cfg, seed=seed, device=DEVICE)
    draft = quantize_decode_params(params)
    gamma, new, max_seq = 4, 64, 512

    # Count verify rounds per call (the loop is the port's own).
    loop, rounds = spec._speculative_loop, []

    def counted(*args, verify, **kw):
        calls = [0]

        def counting_verify(cache, chunk):
            calls[0] += 1
            return verify(cache, chunk)

        out = loop(*args, verify=counting_verify, **kw)
        rounds.append(calls[0])
        return out

    runs = {
        "generate": lambda p: generate(params, p, cfg, max_new_tokens=new,
                                       max_seq=max_seq),
        "dense": lambda p: spec.speculative_generate(
            params, draft, p, cfg, max_new_tokens=new, gamma=gamma,
            max_seq=max_seq),
        "paged": lambda p: spec.paged_speculative_generate(
            params, draft, p, cfg, num_blocks=32, block_size=16,
            max_new_tokens=new, gamma=gamma),
    }
    seconds = {k: 0.0 for k in runs}
    per_round = {"dense": [], "paged": []}
    before = _counts()
    spec._speculative_loop = counted
    try:
        for n in (32, 100, 200):
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            p = torch.tensor([prompt], device=DEVICE)
            out = {}
            for name, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = run(p)[0].tolist()
                torch.cuda.synchronize()
                seconds[name] += time.perf_counter() - t0
                if name != "generate":
                    per_round[name].append(rounds[-1])
            for name in ("dense", "paged"):
                _check_tokens(f"speculative {name} (prompt {n})", out[name],
                              out["generate"], params, cfg, prompt)
        # Host syncs of one call each, on the shortest prompt: every one
        # the sync debug mode reports.
        syncs = {}
        p = torch.tensor([rng.integers(0, cfg.vocab_size, 32).tolist()],
                         device=DEVICE)
        for name in ("dense", "paged"):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    runs[name](p)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs[name] = {"syncs": sum("synchroniz" in str(w.message)
                                        for w in seen),
                           "rounds": rounds[-1]}
    finally:
        spec._speculative_loop = loop
    launches = _launched(before, ("flash_fwd",))
    check(launches["flash_fwd"] > 0, "speculative did not launch K1")
    tokens = 3 * new
    out = {"gamma": gamma, "prompts": [32, 100, 200], "new_tokens": new,
           "tokens_equal": True, "launches": launches,
           "rounds": per_round,
           # Each round accepts a drafts and adds a + 1 tokens: the
           # drafts accepted are new − 1 − rounds (the last round's
           # overshoot aside), over rounds × gamma proposed.
           "acceptance": {k: sum(new - 1 - r for r in v) / (gamma * sum(v))
                          for k, v in per_round.items()},
           "tokens_per_s": {k: tokens / v for k, v in seconds.items()},
           "host_syncs": syncs}
    emit("speculative", **out)
    return out


def phase_train_moe(seed: int) -> dict:
    """fp32 MoE flagship, flash against reference attention over 3 steps;
    then bf16 at seq 512, batch 8, 12 steps on packed Zipf documents."""
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
        tree_leaves,
    )

    vocab = MOE_FLAGSHIP["vocab_size"]
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, vocab, (4, 256), generator=gen,
                             dtype=torch.int32).to(DEVICE)
               for _ in range(3)]
    losses, top1 = {}, {}
    for impl in ("flash", "reference"):
        cfg = moe.MoEConfig(dtype=torch.float32, attn_impl=impl,
                            **MOE_FLAGSHIP)
        tc = TrainConfig(model=cfg)
        state = make_train_state(tc, seed, DEVICE)
        with torch.no_grad():  # the first batch's top-1 experts
            _, seen = _recording_routes(
                lambda: moe.forward(state["params"], batches[0], cfg))
        top1[impl] = [x[..., 0] for x in seen]
        step = make_train_step(tc)
        losses[impl] = [float(step(state, toks)[1]["loss"])
                        for toks in batches]
    flips = sum(int((a != b).sum())
                for a, b in zip(top1["flash"], top1["reference"]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["flash"], losses["reference"]))
    check(rel <= 1e-3, f"train_moe fp32 losses differ by {rel} relative")
    exact = {"ref_top1": [x.cpu() for x in top1["flash"]],
             "losses_flash": losses["flash"],
             "losses_reference": losses["reference"],
             "max_loss_rel_err": rel, "top1_expert_flips": flips,
             "routed_tokens": 4 * 256 * len(top1["flash"])}

    cfg = moe.MoEConfig(dtype=torch.bfloat16, attn_impl="flash",
                        **MOE_FLAGSHIP)
    tc = TrainConfig(model=cfg)
    seq, batch = 512, 8
    dataset = PackedLMDataset(zipf_documents(seed, vocab=vocab), seq_len=seq,
                              seed=seed)
    loader = iter(ShardedLoader(dataset, batch, device=DEVICE,
                                prefetch=False))
    state, step = make_train_state(tc, seed, DEVICE), make_train_step(tc)
    bf16_losses, times = [], []
    for _ in range(12):
        toks = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bf16_losses.append(float(m["loss"]))
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(state["params"]))
    check(finite and all(np.isfinite(bf16_losses)),
          f"train_moe bf16 not finite: {bf16_losses}")
    check(bf16_losses[-1] < bf16_losses[0],
          f"train_moe loss did not fall: {bf16_losses[0]} -> "
          f"{bf16_losses[-1]}")
    p50 = float(np.median(times[2:]))
    ref_top1 = exact.pop("ref_top1")
    out = {"exact": exact, "losses_bf16": bf16_losses, "step_ms": times,
           "step_ms_p50": p50, "tokens_per_s": batch * seq / (p50 / 1e3)}
    emit("train_moe", seq=seq, global_batch=batch, **out)
    out["ref_top1"] = ref_top1
    return out


# The multi-rank phase (mesh_train): worlds of ranks spawned on the one
# card, over gloo (NCCL refuses two ranks on one GPU), every collective
# staged through the host. A collective that waits longer than the
# group's timeout raises; a world that has not reported by its deadline
# is killed and fails the phase.
MESH_GROUP_TIMEOUT_S = 120
MESH_DEADLINE_S = 600
# (label, task, its arguments) per world: the mesh phase's tasks, then
# the pipeline phase's, then (world 4) the reshard phase's, each a stage
# of the same worlds.
MESH_WORLD_2 = (
    ("sp2_ring_flash", "dense_exact",
     dict(axes={"sp": 2}, sp_impl="ring", sp_inner="flash")),
    ("sp2_zigzag_flash", "dense_exact",
     dict(axes={"sp": 2}, sp_impl="zigzag", sp_inner="flash")),
    ("sp2_ulysses_flash", "dense_exact",
     dict(axes={"sp": 2}, sp_impl="ulysses", sp_inner="flash")),
    ("sp2_ring_einsum", "dense_exact", dict(axes={"sp": 2})),
    ("tp2", "dense_exact", dict(axes={"tp": 2})),
    ("dp2", "dense_exact", dict(axes={"dp": 2})),
    ("moe_ep2", "moe_exact", dict(axes={"ep": 2})),
    ("run_sp2_ring_flash", "run",
     dict(axes={"sp": 2}, sp_impl="ring", sp_inner="flash")),
)
MESH_WORLD_4 = (
    ("sp4_zigzag_flash", "dense_exact",
     dict(axes={"sp": 4}, sp_impl="zigzag", sp_inner="flash")),
    ("moe_ep2_sp2_ulysses_flash", "moe_exact",
     dict(axes={"ep": 2, "sp": 2}, sp_impl="ulysses", sp_inner="flash")),
    ("bytes_dp2_tp2", "collective_bytes", dict(axes={"dp": 2, "tp": 2})),
)
PIPE_WORLD_2 = (
    ("pp2_m2", "dense_exact",
     dict(axes={"pp": 2}, pipeline_microbatches=2)),
    ("pp2_m2_forward_nolse", "pipe_forward",
     dict(axes={"pp": 2}, pipeline_microbatches=2)),
    ("run_pp2_m4", "run", dict(axes={"pp": 2}, pipeline_microbatches=4)),
)
PIPE_WORLD_4 = (
    # One layer a stage, one row a microbatch.
    ("pp4_m4", "dense_exact",
     dict(axes={"pp": 4}, pipeline_microbatches=4)),
    ("pp2_tp2", "dense_exact",
     dict(axes={"pp": 2, "tp": 2}, pipeline_microbatches=2)),
    ("pp2_dp2", "dense_exact",
     dict(axes={"dp": 2, "pp": 2}, pipeline_microbatches=2)),
    # The JAX package's nested case: the raw ring with the einsum inner
    # inside each stage (it launches no kernel).
    ("pp2_sp2_ring_einsum", "dense_exact",
     dict(axes={"pp": 2, "sp": 2}, pipeline_microbatches=2)),
)
# The reshard phase's tasks, the third stage of the world of 4.
RESHARD_WORLD_4 = (
    ("reshard_grow_2_to_4", "reshard",
     dict(src=({"tp": 2}, [0, 1]), dst=({"dp": 2, "tp": 2}, None))),
    ("reshard_shrink_4_to_2", "reshard",
     dict(src=({"dp": 2, "tp": 2}, None), dst=({"tp": 2}, [0, 1]))),
    ("restore_pp2_onto_pp2_dp2", "restore",
     dict(src=({"pp": 2}, [0, 1]), dst=({"dp": 2, "pp": 2}, None),
          pipeline_microbatches=2)),
)


def _mesh_dense_exact(dev, ref, axes, sp_impl="ring", sp_inner="einsum",
                      **train) -> dict:
    """The fp32 flagship over ``axes`` (``train``: more TrainConfig
    fields): the first batch's gradients, gathered to rank 0 and held
    there against the one-process flash step's (stacked like the state
    when pipelined), then 3 AdamW steps from the same params."""
    import torch.distributed as dist

    from tpu_composer_torch.models.transformer import (
        ModelConfig,
        init_params,
    )
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.pipeline import stack_layers
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        gather_params,
        make_grad_fn,
        make_train_state,
        make_train_step,
        pipelined,
        tree_leaves,
        tree_unflatten,
    )

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner, **train)
    mesh = make_mesh(axes, dev.type)
    batches = [b.to(dev) for b in ref["batches"]]
    state = make_train_state(tc, ref["seed"], dev, mesh)
    _, grads, _ = make_grad_fn(tc, mesh)(state["params"], batches[0])
    full = gather_params(tc, tree_unflatten(state["params"], grads), mesh)
    grad_err = None
    if dist.get_rank() == 0:
        want = ref["grads"]
        if pipelined(tc, mesh):
            tree = tree_unflatten(init_params(cfg, 0, "meta"), want)
            want = tree_leaves({**tree,
                                "layers": stack_layers(tree["layers"])})
        grad_err = max(max_err(g, r.to(dev)) / max(1.0, float(r.abs().max()))
                       for g, r in zip(tree_leaves(full), want))
    del full, grads
    step = make_train_step(tc, mesh)
    losses, norms = [], []
    for toks in batches:
        state, m = step(state, toks)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "grad_err": grad_err}


def _mesh_moe_exact(dev, ref, axes, sp_impl="ring",
                    sp_inner="einsum") -> dict:
    """The fp32 MoE flagship over ``axes``: the top-1 experts of this
    rank's rows of the first batch, against the one-process model's, and
    3 AdamW steps from the same params."""
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.parallel import train
    from tpu_composer_torch.parallel.mesh import axis_size, make_mesh

    cfg = moe.MoEConfig(dtype=torch.float32, attn_impl="flash",
                        **MOE_FLAGSHIP)
    tc = train.TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner)
    mesh = make_mesh(axes, dev.type)
    batches = [b.to(dev) for b in ref["moe_batches"]]
    state = train.make_train_state(tc, ref["seed"], dev, mesh)
    attn = (train._sp_attn_fn(mesh, sp_impl, sp_inner, cfg.n_heads)
            if axis_size(mesh, "sp") > 1 else None)
    rows = train.local_batch(tc, batches[0], mesh)
    with torch.no_grad():
        _, seen = _recording_routes(
            lambda: moe.forward(state["params"], rows, cfg, attn, mesh))
    n, index = train.data_shards(tc, mesh), train.data_index(tc, mesh)
    want = [t.chunk(n)[index].to(dev) for t in ref["moe_top1"]]
    flips = sum(int((x[..., 0] != w).sum()) for x, w in zip(seen, want))
    step = train.make_train_step(tc, mesh)
    losses = [float(step(state, toks)[1]["loss"]) for toks in batches]
    return {"losses": losses, "rows": index, "top1_flips": flips}


def _mesh_run(dev, ref, axes, sp_impl="ring", sp_inner="einsum",
              steps: int = 12, **train) -> dict:
    """The bf16 flagship over ``axes`` at seq 512, global batch 8, on
    packed Zipf documents (``train``: more TrainConfig fields): losses,
    step times on the host clock (each step synchronised), kernel
    launches a step."""
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner, **train)
    mesh = make_mesh(axes, dev.type)
    seq, batch = 512, 8
    dataset = PackedLMDataset(zipf_documents(ref["seed"],
                                             vocab=FLAGSHIP["vocab_size"]),
                              seq_len=seq, seed=ref["seed"])
    loader = iter(ShardedLoader(dataset, batch, device=dev, prefetch=False))
    state = make_train_state(tc, ref["seed"], dev, mesh)
    step = make_train_step(tc, mesh)
    before = _counts()
    losses, times = [], []
    for _ in range(steps):
        toks = next(loader)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, toks)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    after = _counts()
    return {"losses": losses, "step_ms": times,
            "step_ms_p50": float(np.median(times[2:])),
            "launches_per_step": {k: (after[k] - before[k]) / steps
                                  for k in after},
            "seq": seq, "global_batch": batch}


def _pipe_forward(dev, ref, axes, pipeline_microbatches) -> dict:
    """The fp32 flagship's ``pipelined_forward`` over ``axes`` under
    ``no_grad`` (K1 without lse), held on rank 0 against the one-process
    ``forward`` of the same params (uncounted)."""
    import torch.distributed as dist

    from tpu_composer_torch.models import transformer
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.pipeline import pipelined_forward
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        local_batch,
        make_train_state,
    )

    cfg = transformer.ModelConfig(dtype=torch.float32, attn_impl="flash",
                                  **FLAGSHIP)
    tc = TrainConfig(model=cfg, pipeline_microbatches=pipeline_microbatches)
    mesh = make_mesh(axes, dev.type)
    toks = ref["batches"][0].to(dev)
    params = make_train_state(tc, ref["seed"], dev, mesh)["params"]
    with torch.no_grad():
        got = pipelined_forward(params, local_batch(tc, toks, mesh), cfg,
                                mesh, pipeline_microbatches)
    err = None
    if dist.get_rank() == 0:
        with _uncounted(), torch.no_grad():
            full = transformer.init_params(cfg, ref["seed"], dev)
            err = max_err(got, transformer.forward(full, toks, cfg))
    return {"logits_err": err, "shape": list(got.shape)}


def _steps(tc, mesh, state, batches) -> tuple:
    from tpu_composer_torch.parallel.train import make_train_step

    step, losses = make_train_step(tc, mesh), []
    for toks in batches:
        state, m = step(state, toks)
        losses.append(float(m["loss"]))
    return state, losses


def _mesh_reshard(dev, ref, src, dst, before: int = 3,
                  after: int = 2) -> dict:
    """The fp32 flagship (flash) on mesh ``src`` for ``before`` steps,
    ``reshard_train_state`` onto ``dst``, ``after`` more steps; and the run
    that never resized (``src``, ``dst``: (axes, ranks or None), two
    meshes of this world, rank 0 in both). Returns the losses this rank
    took part in, the seconds the move took it, whether it holds the moved state exactly where ``dst``
    puts it, and on rank 0 whether the state gathered on ``dst`` just
    after the move equals the one gathered on ``src`` just before it,
    bit for bit."""
    import torch.distributed as dist

    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.mesh import in_mesh, make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        abstract_train_state,
        gather_state,
        make_train_state,
        reshard_train_state,
        tree_leaves,
    )

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg)
    a = make_mesh(src[0], dev.type, ranks=src[1])
    b = make_mesh(dst[0], dev.type, ranks=dst[1])
    batches = [t.to(dev) for t in ref["reshard_batches"]]
    control = resized = state = kept = bit_equal = None
    if in_mesh(a):
        control = _steps(tc, a, make_train_state(tc, ref["seed"], dev, a),
                         batches)[1]
        state, resized = _steps(tc, a, make_train_state(
            tc, ref["seed"], dev, a), batches[:before])
        kept = [x.clone() for x in tree_leaves(gather_state(tc, state, a))]
        if dist.get_rank() != 0:
            kept = None
    dist.barrier()
    t0 = time.perf_counter()
    state = reshard_train_state(tc, state, b, a, dev)
    torch.cuda.synchronize(dev)
    move_s = time.perf_counter() - t0
    lands = state is None
    if in_mesh(b):
        lands = all(
            (x.shape, x.dtype, x.device) == (w.shape, w.dtype, dev)
            for x, w in zip(tree_leaves(state),
                            tree_leaves(abstract_train_state(tc, b))))
        moved = tree_leaves(gather_state(tc, state, b))
        if dist.get_rank() == 0:
            bit_equal = len(moved) == len(kept) and all(
                torch.equal(x, y) for x, y in zip(moved, kept))
        del moved, kept
        state, after_losses = _steps(tc, b, state, batches[before:])
        resized = (resized or [None] * before) + after_losses
    return {"control": control, "resized": resized, "lands": lands,
            "in_dst": in_mesh(b), "bit_equal": bit_equal, "move_s": move_s}


def _mesh_restore(dev, ref, src, dst, **train) -> dict:
    """The fp32 flagship (flash) 2 steps on ``src``; rank 0 saves the
    gathered state; every rank of ``dst`` restores its shards and takes
    step 3; and step 3 of the run that never stopped. On rank 0 also
    whether the restored state, gathered on ``dst``, equals the saved
    one bit for bit."""
    import torch.distributed as dist

    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel import checkpoint as ckpt
    from tpu_composer_torch.parallel.mesh import in_mesh, make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        gather_state,
        make_train_state,
        tree_leaves,
    )

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg, **train)
    a = make_mesh(src[0], dev.type, ranks=src[1])
    b = make_mesh(dst[0], dev.type, ranks=dst[1])
    batches = [t.to(dev) for t in ref["batches"]]
    directory = os.path.join(ref["workdir"], "pipeline_ckpt")
    control = resumed = saved = bit_equal = None
    if in_mesh(a):
        control = _steps(tc, a, make_train_state(tc, ref["seed"], dev, a),
                         batches)[1][2]
        state, _ = _steps(tc, a, make_train_state(tc, ref["seed"], dev, a),
                          batches[:2])
        full = gather_state(tc, state, a)
        if dist.get_rank() == 0:
            ckpt.save(directory, full, step=2)
            saved = tree_leaves(full)
        del state, full
    dist.barrier()
    if in_mesh(b):
        out = ckpt.restore(directory, tc, dev, mesh=b)
        check(out["step"] == 2, f"restored step {out['step']}")
        restored = tree_leaves(gather_state(tc, out["state"], b))
        if dist.get_rank() == 0:
            bit_equal = len(restored) == len(saved) and all(
                torch.equal(x, y) for x, y in zip(restored, saved))
        del restored, saved
        resumed = _steps(tc, b, out["state"], batches[2:])[1][0]
    return {"control": control, "resumed": resumed, "bit_equal": bit_equal}


def _mesh_collective_bytes(dev, ref, axes) -> dict:
    """One step of the bf16 flagship (flash, seq 512, global batch 8)
    over ``axes`` under ``record_collectives``: what this rank sent, per
    mesh dim, its gradient bytes and its rows of the batch."""
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        local_batch,
        make_train_state,
        make_train_step,
        tree_leaves,
    )
    from tpu_composer_torch.workload.collective_bytes import (
        record_collectives,
    )

    tc = TrainConfig(model=ModelConfig(dtype=torch.bfloat16,
                                       attn_impl="flash", **FLAGSHIP))
    mesh = make_mesh(axes, dev.type)
    state = make_train_state(tc, ref["seed"], dev, mesh)
    gen = torch.Generator().manual_seed(ref["seed"])
    tokens = torch.randint(0, FLAGSHIP["vocab_size"], (8, 512),
                           generator=gen, dtype=torch.int32).to(dev)
    step = make_train_step(tc, mesh)
    with record_collectives(mesh) as rec:
        step(state, tokens)
        torch.cuda.synchronize(dev)
    return {"summary": rec.summary(),
            "grad_bytes": sum(p.numel() * p.element_size()
                              for p in tree_leaves(state["params"])),
            "rows": local_batch(tc, tokens, mesh).shape[0], "seq": 512}


def _collective_bytes_record(label: str, per_rank: list) -> dict:
    """Each rank's per-axis bytes against the closed form of the
    flagship's dp x tp step: over dp its gradient bytes (one flat
    all-reduce) and two fp32 scalars (the loss, the squared gradient
    norm); over tp, per layer four (rows, S, d) bf16 activations (the
    attention and ffn exits forward, their entries' cotangents
    backward), the embedding gathered once (V, d) in bf16, and the
    squared norm."""
    bf16, f32 = 2, 4
    d, v, layers = (FLAGSHIP["d_model"], FLAGSHIP["vocab_size"],
                    FLAGSHIP["n_layers"])
    out = {"per_rank": []}
    for x in per_rank:
        got = x["summary"]["per_axis_bytes"]
        want = {"dp": x["grad_bytes"] + 2 * f32,
                "tp": layers * 4 * x["rows"] * x["seq"] * d * bf16
                + v * d * bf16 + f32}
        check(got == want, f"mesh {label}: per-axis bytes {got}, closed"
                           f" form {want}")
        out["per_rank"].append({"per_axis_bytes": got, "closed_form": want,
                                "op_counts": x["summary"]["op_counts"]})
    out["ops_rank0"] = per_rank[0]["summary"]["ops"]
    return out


_MESH_TASKS = {"dense_exact": _mesh_dense_exact,
               "collective_bytes": _mesh_collective_bytes,
               "moe_exact": _mesh_moe_exact, "run": _mesh_run,
               "pipe_forward": _pipe_forward, "reshard": _mesh_reshard,
               "restore": _mesh_restore}


def _mesh_rank(rank, world, init, device, stages, ref_path, gos,
               results, backend) -> None:
    """One rank of a spawned world: joins the ``backend`` group (gloo,
    or NCCL with a card per rank), then for each
    stage (a phase's tasks) waits for its ``go``, sets the launch counts
    to 0, runs the tasks and sends the parent its results and counts (or
    its traceback). It prints nothing to stdout."""
    import traceback

    import torch.distributed as dist

    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        sys.path.insert(0, HERE)
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from tpu_composer_torch.parallel.mesh import init_world

        dev = init_world(backend, rank, world, init, device,
                         timeout_s=MESH_GROUP_TIMEOUT_S)
        ref = None
        for stage, tasks in enumerate(stages):
            if not gos[stage].wait(MESH_DEADLINE_S):
                raise RuntimeError(f"the parent never started stage {stage}")
            if ref is None:
                ref = torch.load(ref_path, weights_only=True)
            _reset_counts()
            out = {}
            for label, kind, kw in tasks:
                t0 = time.perf_counter()
                out[label] = _MESH_TASKS[kind](dev, ref, **kw)
                out[label]["s"] = time.perf_counter() - t0
                out[label]["transport"] = dist.get_backend()
            out["launches"] = _counts()
            results.put((rank, stage, None, out))
    except BaseException:
        results.put((rank, None, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _World:
    """``n`` spawned ranks of ``_mesh_rank``, started at once, which run
    ``stages`` in turn: ``join(i)`` starts stage i and collects its
    results or fails; ``close`` never leaves a rank running."""

    def __init__(self, n: int, stages, ref_path: str, workdir: str,
                 backend: str = "gloo"):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.results = n, ctx.Queue()
        self.gos = [ctx.Event() for _ in stages]
        self.done = False
        init = f"file://{workdir}/world{n}"
        self.procs = [ctx.Process(target=_mesh_rank, args=(
            r, n, init, DEVICE, stages, ref_path, self.gos, self.results,
            backend))
            for r in range(n)]
        for p in self.procs:
            p.start()

    def join(self, stage: int, deadline_s: float = MESH_DEADLINE_S) -> list:
        import queue

        self.gos[stage].set()
        got, deadline, dead_since = {}, time.monotonic() + deadline_s, None
        try:
            while len(got) < self.n:
                missing = sorted(set(range(self.n)) - set(got))
                check(time.monotonic() < deadline,
                      f"world of {self.n}: ranks {missing} did not report"
                      f" stage {stage} within {deadline_s} s")
                try:
                    rank, at, err, out = self.results.get(timeout=2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if not p.is_alive() and r not in got]
                    if dead and dead_since is None:
                        dead_since = time.monotonic()
                    check(not dead or time.monotonic() - dead_since < 10,
                          f"world of {self.n}: ranks {dead} exited without"
                          " a result")
                    continue
                check(err is None,
                      f"world of {self.n}: rank {rank} failed:\n{err}")
                check(at == stage, f"rank {rank} reported stage {at}")
                got[rank] = out
        except BaseException:
            self.close()
            raise
        if stage == len(self.gos) - 1:
            self.done = True
            self.close()
        return [got[r] for r in range(self.n)]

    def close(self) -> None:
        """Join the ranks after their last stage; kill them otherwise."""
        for p in self.procs:
            p.join(timeout=30 if self.done else 0)
            if p.is_alive():
                p.kill()
                p.join(10)


def _dense_exact_record(label: str, got: dict, exact: dict) -> dict:
    """Rank 0's losses, grad norms and step-1 gradient error over a mesh,
    held to ``train_exact``'s limits against its one-process flash
    step."""
    rec = {"losses": got["losses"], "grad_norms": got["grad_norms"]}
    rec["loss_rel_err"] = max(
        abs(a - b) / abs(b)
        for a, b in zip(got["losses"], exact["losses_flash"]))
    rec["grad_norm_rel_err"] = max(
        abs(a - b) / b for a, b in zip(got["grad_norms"],
                                       exact["grad_norms_flash"]))
    rec["grad_rel_err"] = got["grad_err"]
    check(rec["loss_rel_err"] <= 1e-4,
          f"mesh {label}: losses off by {rec['loss_rel_err']}")
    check(rec["grad_norm_rel_err"] <= 1e-3,
          f"mesh {label}: grad norms off by {rec['grad_norm_rel_err']}")
    check(rec["grad_rel_err"] <= 1e-4,
          f"mesh {label}: step-1 gradients off by {rec['grad_rel_err']}")
    return rec


def _run_record(label: str, per_rank: list) -> dict:
    """The bf16 run: the loss falls and stays finite; per rank its step
    p50 and K1-with-lse, B3 and B4 launches a step (each > 0)."""
    losses = per_rank[0]["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"mesh {label}: losses {losses}")
    rec = {"losses": losses, "per_rank": [
        {"step_ms_p50": x["step_ms_p50"],
         "launches_per_step": {k: x["launches_per_step"][k]
                               for k in ("flash_fwd_lse", "flash_bwd_dq",
                                         "flash_bwd_dkv")}}
        for x in per_rank]}
    check(all(v > 0 for x in rec["per_rank"]
              for v in x["launches_per_step"].values()),
          f"mesh {label}: a rank launched no flash kernel")
    return rec


def _world_counts(results: dict) -> dict:
    """The launch counts of every rank of the worlds, summed."""
    counts = {}
    for ranks in results.values():
        for r in ranks:
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v
    return counts


def _task_record(n: int, kw: dict, per_rank: list) -> dict:
    return {"world": n,
            **{"mesh" if k == "axes" else k: v for k, v in kw.items()},
            "s": max(x["s"] for x in per_rank),
            "transport": per_rank[0]["transport"]
            + (" (host-staged)" if per_rank[0]["transport"] == "gloo"
               else "")}


def _write_ref(seed: int, exact: dict, workdir: str, **more) -> str:
    """What the ranks read: the seed, the fp32 tokens (4, 256) of the
    exact and reshard tasks, ``train_exact``'s step-1 gradients and
    ``more``; returns its path."""
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, FLAGSHIP["vocab_size"], (4, 256),
                             generator=gen, dtype=torch.int32)
               for _ in range(5)]
    path = os.path.join(workdir, "ref.pt")
    torch.save({"seed": seed, "batches": batches[:3],
                "reshard_batches": batches, "workdir": workdir,
                "grads": exact["ref_grads"], **more}, path)
    return path


def phase_mesh_train(seed: int, exact: dict, moe_exact: dict, workdir: str,
                     worlds: dict) -> dict:
    """The multi-rank training step on the one card: a world of 2 ranks
    and one of 4 over gloo, each rank on the card, started here into
    ``worlds`` (their second stage is ``pipeline_train``'s, the third of
    the world of 4 ``reshard_train``'s). The fp32
    flagship over each mesh of ``MESH_WORLD_2``/``MESH_WORLD_4`` against
    the one-process flash step (``train_exact``), the fp32 MoE flagship
    against ``train_moe``'s, and a bf16 run. Returns the worlds' launch
    counts, summed over ranks."""
    gen = torch.Generator().manual_seed(seed)
    moe_batches = [torch.randint(0, MOE_FLAGSHIP["vocab_size"], (4, 256),
                                 generator=gen, dtype=torch.int32)
                   for _ in range(3)]
    ref_path = _write_ref(seed, exact, workdir, moe_batches=moe_batches,
                          moe_top1=moe_exact["ref_top1"])
    t0 = time.perf_counter()
    worlds[2] = _World(2, (MESH_WORLD_2, PIPE_WORLD_2), ref_path, workdir)
    worlds[4] = _World(4, (MESH_WORLD_4, PIPE_WORLD_4, RESHARD_WORLD_4),
                       ref_path, workdir)
    # The world of 4 starts up beside the world of 2 and waits for it.
    results = {n: worlds[n].join(0) for n in (2, 4)}
    wall = time.perf_counter() - t0

    out = {"wall_s": wall}
    for n, tasks in ((2, MESH_WORLD_2), (4, MESH_WORLD_4)):
        ranks = results[n]
        for label, kind, kw in tasks:
            per_rank = [r[label] for r in ranks]
            rec = _task_record(n, kw, per_rank)
            if kind == "dense_exact":
                rec.update(_dense_exact_record(label, per_rank[0], exact))
            elif kind == "moe_exact":
                got = per_rank[0]
                rec["losses"] = got["losses"]
                rec["loss_rel_err"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(got["losses"],
                                    moe_exact["exact"]["losses_flash"]))
                # Ranks that share rows (sp, tp) route them alike: count
                # each row block once.
                rec["top1_flips"] = sum(
                    {x["rows"]: x["top1_flips"] for x in per_rank}.values())
                check(rec["loss_rel_err"] <= 1e-3,
                      f"mesh {label}: MoE losses off by"
                      f" {rec['loss_rel_err']}")
            elif kind == "collective_bytes":
                rec.update(_collective_bytes_record(label, per_rank))
            else:
                rec.update(_run_record(label, per_rank))
            out[label] = rec
            emit("mesh_train", check=label, **rec)
    out["launches"] = _world_counts(results)
    return out


# The pipeline and reshard paths' flash calls, held against their plain
# versions on the card: (label, (B, S, H, KV, D), dtype, with lse). The
# bf16 run's microbatch (global batch 8 over M = 4), the exact half's
# microbatches at M = 2 and M = 4 and under tp = 2 (half the heads), the
# forward under no_grad (K1 without lse), and the reshard's tp = 2 mesh
# over 2 ranks (the whole batch; its dp = 2 x tp = 2 and pipelined
# meshes give exact_tp2's, exact_m2's and exact_m4's shapes).
PIPE_SHAPES = (
    ("run_microbatch", (2, 512, 8, 2, 64), torch.bfloat16, True),
    ("exact_m2", (2, 256, 8, 2, 64), torch.float32, True),
    ("exact_m4", (1, 256, 8, 2, 64), torch.float32, True),
    ("exact_tp2", (2, 256, 4, 1, 64), torch.float32, True),
    ("forward_m2_nolse", (2, 256, 8, 2, 64), torch.float32, False),
    ("reshard_tp2", (4, 256, 4, 1, 64), torch.float32, True),
)


def _pipeline_kernels(gen: torch.Generator) -> dict:
    """K1 (with lse, and without), B3 and B4 at ``PIPE_SHAPES`` against
    their plain versions (uncounted), and the three training kernels'
    device times at the bf16 run's microbatch."""
    from tpu_composer_torch.ops.attention import (
        _delta,
        flash_bwd_cuda,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_plain,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    errs = {}
    with _uncounted():
        for label, shape, dtype, with_lse in PIPE_SHAPES:
            q, k, v, do = _attn_inputs(gen, shape, dtype)
            if not with_lse:
                out, _ = flash_fwd_cuda(q, k, v, True)
                torch.cuda.synchronize()
                e = max_err(out, flash_fwd_plain(q, k, v, True)[0])
                check(e <= TOL[dtype], f"flash_fwd {label} error {e}")
                errs[label] = {"shape": list(shape), "out": e}
                continue
            out, lse = flash_fwd_cuda(q, k, v, True, with_lse=True)
            out_w, lse_w = flash_fwd_plain(q, k, v, True, with_lse=True)
            got = flash_bwd_cuda(q, k, v, out, lse, do, None, True)
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, out_w), max_err(lse, lse_w)
            check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
            check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse {e_lse}")
            worst = {}
            _bwd_errors(got, flash_bwd_plain(q, k, v, out, lse, do, None,
                                             True),
                        dtype, f"{label} {list(shape)}", worst)
            errs[label] = {"shape": list(shape), "out": e_out,
                           "lse": e_lse, **worst}
        # Device times at the bf16 run's microbatch (the last bf16 inputs).
        q, k, v, do = _attn_inputs(gen, PIPE_SHAPES[0][1], torch.bfloat16)
        out, lse = flash_fwd_cuda(q, k, v, True, with_lse=True)
        delta = _delta(out, do)
        times = {name: timed(fn)[0] for name, fn in (
            ("flash_fwd_lse", lambda: flash_fwd_cuda(q, k, v, True, True)),
            ("flash_bwd_dq",
             lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)),
            ("flash_bwd_dkv",
             lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)))}
    bounds = _attn_bounds(PIPE_SHAPES[0][1], torch.bfloat16)
    return {"errors": errs, "microbatch_ms": times,
            "microbatch_bound_ms": {n: bounds[n]["bound_ms"] for n in times}}


def _world_check(counts: dict, phase: str) -> None:
    """K1 with lse, B3 and B4 each launched in the ranks of ``phase``."""
    check(all(counts[k] > 0 for k in ("flash_fwd_lse", "flash_bwd_dq",
                                      "flash_bwd_dkv")),
          f"{phase}: the ranks launched {counts}")


def _stage_records(phase: str, n: int, tasks, ranks: list,
                   exact: dict) -> dict:
    """Check and print the results of one stage's ``tasks`` in the world
    of ``n`` ranks (``ranks``: each rank's results): the dense meshes
    against ``train_exact``, the pipelined forward against ``forward``,
    the bf16 runs, the reshards and restores against the never-resized
    run and the source's state."""
    out = {}
    for label, kind, kw in tasks:
        per_rank = [r[label] for r in ranks]
        rec = _task_record(n, kw, per_rank)
        got = per_rank[0]  # rank 0 is in both meshes of a reshard
        if kind == "dense_exact":
            rec.update(_dense_exact_record(label, got, exact))
        elif kind == "pipe_forward":
            rec["logits_err"] = got["logits_err"]
            check(rec["logits_err"] <= TOL[torch.float32],
                  f"{phase} {label}: logits off by {rec['logits_err']}")
        elif kind == "run":
            rec.update(_run_record(label, per_rank))
        else:
            rec["bit_equal"] = got["bit_equal"]
            check(got["bit_equal"] is True,
                  f"{phase} {label}: the state on the target mesh is not"
                  " the source's, bit for bit")
        if kind == "reshard":
            rec["losses_resized"] = got["resized"]
            rec["losses_never_resized"] = got["control"]
            rec["loss_rel_err"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(got["resized"], got["control"]))
            check(rec["loss_rel_err"] <= 2e-4,
                  f"{phase} {label}: losses off by {rec['loss_rel_err']}")
            check(all(x["lands"] for x in per_rank),
                  f"{phase} {label}: a rank's state is not its shard of"
                  " the target mesh")
            rec["target_ranks"] = [r for r, x in enumerate(per_rank)
                                   if x["in_dst"]]
            rec["move_s"] = max(x["move_s"] for x in per_rank)
        elif kind == "restore":
            rec["loss_resumed"] = got["resumed"]
            rec["loss_never_stopped"] = got["control"]
            resumed = [x["resumed"] for x in per_rank]
            rec["loss_rel_err"] = max(
                abs(a - got["control"]) / abs(got["control"])
                for a in resumed)
            check(rec["loss_rel_err"] <= 2e-4,
                  f"{phase} {label}: resumed losses {resumed} against"
                  f" {got['control']}")
        out[label] = rec
        emit(phase, check=label, **rec)
    return out


def phase_pipeline_train(gen: torch.Generator, exact: dict,
                         worlds: dict) -> dict:
    """GPipe over 'pp', in the worlds ``mesh_train`` started (their
    second stage). Returns the ranks' launch counts, summed."""
    kernels = _pipeline_kernels(gen)
    emit("pipeline_train", check="kernels_at_microbatch_shapes", **kernels)
    t0 = time.perf_counter()
    results = {n: worlds[n].join(1) for n in (2, 4)}
    out = {"wall_s": time.perf_counter() - t0, "kernels": kernels}
    for n, tasks in ((2, PIPE_WORLD_2), (4, PIPE_WORLD_4)):
        out.update(_stage_records("pipeline_train", n, tasks, results[n],
                                  exact))
    out["launches"] = _world_counts(results)
    _world_check(out["launches"], "pipeline_train")
    return out


def phase_reshard_train(exact: dict, worlds: dict) -> dict:
    """The live reshard and the restore onto another mesh, in the world
    of 4 that ``mesh_train`` started (its third stage). Returns the
    ranks' launch counts, summed."""
    t0 = time.perf_counter()
    results = {4: worlds[4].join(2)}
    out = {"wall_s": time.perf_counter() - t0}
    out.update(_stage_records("reshard_train", 4, RESHARD_WORLD_4,
                              results[4], exact))
    out["launches"] = _world_counts(results)
    _world_check(out["launches"], "reshard_train")
    return out


def phase_mesh_nccl(seed: int) -> dict:
    """A world of one rank over NCCL: ``make_mesh`` over the card and
    ``fit`` 3 steps with it give the meshless ``fit``'s losses bit for
    bit; the allreduce probe over one device reports 0.0."""
    import torch.distributed as dist

    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.collectives import (
        allreduce_bandwidth_gbps,
    )
    from tpu_composer_torch.parallel.mesh import init_world, make_mesh
    from tpu_composer_torch.parallel.train import TrainConfig
    from tpu_composer_torch.workload.trainer import fit

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg)
    dataset = PackedLMDataset(zipf_documents(seed,
                                             vocab=FLAGSHIP["vocab_size"]),
                              seq_len=512, seed=seed)
    with tempfile.TemporaryDirectory() as workdir:
        init_world("nccl", 0, 1, f"file://{workdir}/nccl", DEVICE)
        try:
            mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, "cuda")
            backend = dist.get_backend()
            meshed = fit(tc, dataset, total_steps=3, global_batch=8,
                         log_every=1, seed=seed, device=DEVICE, mesh=mesh)
            busbw = allreduce_bandwidth_gbps(mesh)
        finally:
            dist.destroy_process_group()
    plain = fit(tc, dataset, total_steps=3, global_batch=8, log_every=1,
                seed=seed, device=DEVICE)
    got = [r["loss"] for r in meshed.history]
    want = [r["loss"] for r in plain.history]
    check(got == want, f"NCCL world-1 fit losses {got} != meshless {want}")
    check(busbw == 0.0, f"allreduce probe on one device: {busbw}")
    out = {"transport": backend, "losses": got, "losses_meshless": want,
           "allreduce_gbps": busbw}
    emit("mesh_nccl", **out)
    return out


# The composed worker's new kernel shapes: the probe's flash sweep
# (bf16, causal, D = 128: (B, S, H, KV, D)), qualify_large's model, and
# the decode stage's paged cache (8 rows, 16 heads over 4 KV heads of 64,
# blocks of 128, 2 table slots a row, lengths 129-256: every row's
# second block partly filled).
COMPOSED_SHAPES = (
    ("sweep_s1024", (2, 1024, 8, 8, 128)),
    ("sweep_s2048_gqa", (2, 2048, 8, 2, 128)),
    ("sweep_s4096_gqa", (1, 4096, 8, 2, 128)),
    ("sweep_s8192_mqa", (1, 8192, 4, 1, 128)),
    ("qualify_large", (8, 2048, 16, 16, 128)),
)
DECODE_PAGED = dict(h=16, kv=4, dh=64, bs=128, mb=2)
H100_MODEL = "nvidia-h100-sxm"
# Per-stage deadlines of the probe inside this run's time limit (the
# probe's own defaults are for an operator's node, with more headroom).
PROBE_TIMEOUTS_S = {"backend_init": 90.0, "matmul": 60.0,
                    "flash_attn": 240.0, "qualify": 120.0,
                    "qualify_large": 180.0, "decode": 240.0}


def _composed_kernels(gen: torch.Generator) -> dict:
    """At ``COMPOSED_SHAPES``: K1 with lse, B3 and B4 against their plain
    versions, K1 without lse against K1 with lse bit for bit, and their
    device times beside SDPA's forward and backward; at the decode
    stage's paged geometry, K2 against the gather path (fp32, bf16 and
    int8 pools) and its time. Every output is held both to the file's
    tolerance and row by row (``row_err``). Uncounted."""
    from tpu_composer_torch.ops.attention import (
        _delta,
        _dkv_split,
        _fwd_rows,
        flash_bwd_cuda,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_plain,
        flash_fwd_cuda,
        flash_fwd_plain,
    )
    from tpu_composer_torch.ops.paged_attention import (
        _decode_split,
        paged_decode_cuda,
        paged_decode_plain,
    )

    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_rec = {}
    with _uncounted():
        for label, shape in COMPOSED_SHAPES:
            q, k, v, do = _attn_inputs(gen, shape, dtype)
            nolse, _ = flash_fwd_cuda(q, k, v, True)
            out, lse = flash_fwd_cuda(q, k, v, True, with_lse=True)
            out_w, lse_w = flash_fwd_plain(q, k, v, True, with_lse=True)
            got = flash_bwd_cuda(q, k, v, out, lse, do, None, True)
            want = flash_bwd_plain(q, k, v, out, lse, do, None, True)
            torch.cuda.synchronize()
            e_nolse, e_out = max_err(nolse, out_w), max_err(out, out_w)
            e_lse = max_err(lse, lse_w)
            check(torch.equal(nolse, out),
                  f"flash_fwd {label}: without lse {e_nolse} != with lse"
                  f" {e_out}, not bit for bit")
            check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
            check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse {e_lse}")
            rows_rel = {"out": row_err(out, out_w)}
            worst = {}
            _bwd_errors(got, want, dtype, f"{label} {list(shape)}", worst)
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                rows_rel[name] = row_err(a, w)
            for name, e in rows_rel.items():
                check(e <= ROW_TOL[dtype],
                      f"{label} {name}: worst row error {e} of its own"
                      f" max|ref| (tolerance {ROW_TOL[dtype]})")
            del got, want, out_w, lse_w
            delta = _delta(out, do)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd():
                with torch.no_grad():
                    return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

            recorded = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_bwd():
                return torch.autograd.grad(recorded, (qt, kt, vt), dot,
                                           retain_graph=True)

            def plain_bwd():
                return flash_bwd_plain(q, k, v, out, lse, do, None, True)

            times = {
                "flash_fwd": timings(
                    lambda: flash_fwd_cuda(q, k, v, True),
                    lambda: flash_fwd_plain(q, k, v, True), sdpa_fwd),
                "flash_fwd_lse": timings(
                    lambda: flash_fwd_cuda(q, k, v, True, True),
                    lambda: flash_fwd_plain(q, k, v, True, True), sdpa_fwd),
                "flash_bwd_dq": timings(
                    lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
                    plain_bwd, sdpa_bwd),
                "flash_bwd_dkv": timings(
                    lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                               True),
                    plain_bwd, sdpa_bwd),
            }
            bounds = _attn_bounds(shape, dtype)
            for name in times:
                times[name].update(bounds[name])
            b, sq, h, kv, _ = shape
            rows, split = _fwd_rows(b, h, sq), _dkv_split(b, kv, h // kv, sq)
            out_rec[label] = {
                "shape": list(shape), "out": e_out, "out_nolse": e_nolse,
                "lse": e_lse, **worst, "row_relative": rows_rel,
                "timing": times,
                "geometry": {"flash_fwd_rows": rows,
                             "flash_fwd_ctas": b * h * -(-sq // rows),
                             "flash_bwd_dq_ctas": b * h * -(-sq // 64),
                             "flash_bwd_dkv_split": split,
                             "flash_bwd_dkv_ctas":
                                 b * kv * -(-sq // 64) * split}}
            emit("composed_worker", check=f"kernels_{label}",
                 **out_rec[label])
            del q, k, v, do, out, lse, qt, kt, vt, recorded
            torch.cuda.empty_cache()

        k2 = {}
        for name, pool_dtype, quant in (("fp32", torch.float32, False),
                                        ("bf16", torch.bfloat16, False),
                                        ("int8_q_bf16", torch.bfloat16,
                                         True)):
            worst = worst_row = 0.0
            for lengths in ([129, 130, 192, 193, 200, 255, 256, 256], None):
                if lengths is None:
                    lengths = torch.randint(129, 257, (8,), generator=gen)
                args = _paged_inputs(gen, pool_dtype, quant,
                                     lengths=lengths, **DECODE_PAGED)
                got = paged_decode_cuda(*args)
                want = paged_decode_plain(*args)
                torch.cuda.synchronize()
                worst = max(worst, max_err(got, want))
                worst_row = max(worst_row, row_err(got, want))
            check(worst <= TOL[pool_dtype],
                  f"paged_decode Bs=128 {name} error {worst}")
            check(worst_row <= ROW_TOL[pool_dtype],
                  f"paged_decode Bs=128 {name}: worst row error {worst_row}"
                  f" of its own max|ref| (tolerance {ROW_TOL[pool_dtype]})")
            k2[name] = {"max_abs_err": worst, "row_relative": worst_row,
                        "lengths": args[4].tolist()}
            if name == "bf16":
                k2[name].update(timings(lambda: paged_decode_cuda(*args),
                                        lambda: paged_decode_plain(*args)))
                k2[name]["bound_ms"], k2[name]["bound_by"] = \
                    _paged_bound(args)
        chunk, n_split = _decode_split(DECODE_PAGED["bs"], DECODE_PAGED["mb"])
        out_rec["paged_decode_bs128"] = {
            "shape": [8, DECODE_PAGED["h"], DECODE_PAGED["kv"],
                      DECODE_PAGED["dh"], DECODE_PAGED["bs"],
                      DECODE_PAGED["mb"]],
            "geometry": {"chunk": chunk, "n_split": n_split,
                         "split_ctas": 8 * DECODE_PAGED["kv"] * n_split},
            **k2}
        emit("composed_worker", check="kernels_paged_decode_bs128",
             **out_rec["paged_decode_bs128"])
    return out_rec


def _compose_one_gpu(slice_name: str = "chip-smoke"):
    """One H100 host of 1 GPU composed by hand: the slice solved and its
    coordinate env put in the worker's CDI spec. The operator's specs
    (``operator_attach``, ``operator_request``) are held to it."""
    from tpu_composer_torch.admission import slice_env
    from tpu_composer_torch.agent.cdi import generate_cdi_spec
    from tpu_composer_torch.api.types import SliceStatus
    from tpu_composer_torch.topology import solve_slice

    shape = solve_slice(H100_MODEL, 1)
    status = SliceStatus(name=slice_name, topology=shape.topology,
                         num_hosts=shape.num_hosts,
                         chips_per_host=shape.chips_per_host,
                         worker_hostnames=["localhost"])
    env = slice_env(status, 0, H100_MODEL)
    return generate_cdi_spec(status.name, 0, shape.worker_chip_indices(0),
                             env=env, model=H100_MODEL)


def _gpu_node_minor(path: str):
    """The minor of a per-GPU node ``/dev/nvidia<minor>``; None for the
    control nodes and anything else."""
    digits = os.path.basename(path)[len("nvidia"):]
    return int(digits) if path.startswith("/dev/nvidia") and digits.isdigit() else None


def _cuda_nodes() -> list:
    """The per-GPU device nodes this process holds open: its CUDA
    context's card."""
    nodes = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue  # the listing's own descriptor, closed meanwhile
        if _gpu_node_minor(target) is not None:
            nodes.add(target)
    return sorted(nodes)


def phase_operator_attach(workdir: str, card: dict) -> dict:
    """The port's operator composes this card (docstring, phase 19).
    Returns the running operator and what it composed; ``operator_busy``
    stops it."""
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.api import Node, ObjectMeta
    from tpu_composer_torch.controllers import (
        ComposableResourceReconciler, ResourceTiming)
    from tpu_composer_torch.fabric.inmem import InMemoryPool
    from tpu_composer_torch.runtime import Manager, Store

    root = os.path.join(workdir, "operator")
    agent = LocalNodeAgent(cdi_dir=os.path.join(root, "cdi"),
                           state_dir=os.path.join(root, "state"))
    driver = agent.ensure_driver("localhost")
    gpus = agent.gpus()
    check(gpus, "the node agent lists no GPU on this host")
    store = Store()
    node = Node(metadata=ObjectMeta(name="localhost"))
    node.status.tpu_slots = len(gpus)
    store.create(node)
    pool = InMemoryPool()
    pool.reserve_slice("chip-smoke", H100_MODEL, "1x1", ["localhost"])
    mgr = Manager(store=store)
    mgr.add_controller(ComposableResourceReconciler(
        store, pool, agent,
        timing=ResourceTiming(attach_poll=0.05, visibility_poll=0.05)))
    mgr.start(workers_per_controller=2)
    try:
        out = _attach_and_check(store, agent, gpus, driver, card)
    except BaseException:
        mgr.stop()
        raise
    return {"manager": mgr, **out}


def _attach_and_check(store, agent, gpus, driver, card) -> dict:
    from tpu_composer_torch.agent.cdi import spec_path
    from tpu_composer_torch.api import (
        ComposableResource, ComposableResourceSpec, ObjectMeta)
    from tpu_composer_torch.api.dra import ResourceSlice

    name = "chip-smoke-worker0"
    t0 = time.perf_counter()
    store.create(ComposableResource(
        metadata=ObjectMeta(name=name),
        spec=ComposableResourceSpec(
            type="gpu", model=H100_MODEL, target_node="localhost",
            chip_count=1, slice_name="chip-smoke", worker_id=0,
            topology="1x1")))
    deadline = t0 + 30.0
    while True:
        cr = store.get(ComposableResource, name)
        if cr.status.state == "Online" or time.perf_counter() > deadline:
            break
        time.sleep(0.002)
    attach_ms = (time.perf_counter() - t0) * 1e3
    check(cr.status.state == "Online",
          f"the CR is not Online after 30 s: {cr.status.to_dict()}")
    group = f"{cr.spec.slice_name}-worker{cr.spec.worker_id}"
    check(agent.check_visible("localhost", cr.status.device_ids, group=group),
          "the composed GPU does not enumerate on the host")

    hand = _compose_one_gpu()
    path = spec_path(agent.cdi_dir, hand)
    check(os.path.exists(path), f"no CDI spec at {path}")
    with open(path) as f:
        doc = json.load(f)
    edits = doc["devices"][0]["containerEdits"]
    spec_env = dict(e.split("=", 1) for e in edits["env"])
    check(spec_env == hand.env,
          f"the operator's spec env {spec_env} != the hand composition's"
          f" {hand.env}")
    nodes = [n["path"] for n in edits["deviceNodes"]]
    gpu_nodes = [n for n in nodes if _gpu_node_minor(n) is not None]
    check(nodes[1:] == hand.device_nodes[1:],
          f"the spec's control nodes {nodes[1:]} != {hand.device_nodes[1:]}")
    cuda_nodes = _cuda_nodes()
    check(len(gpu_nodes) == 1 and gpu_nodes == cuda_nodes,
          f"the spec's GPU node {gpu_nodes} is not the card CUDA holds open"
          f" {cuda_nodes}")
    cuda_bus = _card_bus()
    minor = _gpu_node_minor(gpu_nodes[0])
    agent_bus = dict((m, b) for b, m in gpus).get(minor)
    check(agent_bus is not None, f"minor {minor} is not one of {gpus}")
    check(agent_bus in ("", cuda_bus),
          f"the spec's GPU has bus id {agent_bus}, CUDA's card {cuda_bus}")
    listed = [(d.uuid, d.cdi_device_id) for s in store.list(ResourceSlice)
              for d in s.spec.devices]
    check(listed == [(u, cr.status.cdi_device_id) for u in cr.status.device_ids],
          f"the ResourceSlice lists {listed}, not {cr.status.device_ids}")
    rec = {"attach_to_online_host_ms": attach_ms, "card": card["nvidia_smi"],
           "tpu_slots": len(gpus),
           "driver": driver, "gpus": [{"bus_id": b, "minor": m} for b, m in gpus],
           "spec": doc["devices"][0]["name"], "cdi": cr.status.cdi_device_id,
           "device_nodes": nodes, "cuda_nodes": cuda_nodes,
           "cuda_bus_id": cuda_bus,
           "agent_bus_id": agent_bus or "not reported by the host's driver",
           "device_ids": cr.status.device_ids,
           "chip_indices": cr.status.chip_indices}
    emit("operator_attach", **rec)
    return {"agent": agent, "group": group,
            "device_ids": list(cr.status.device_ids), "env": spec_env, **rec}


def _get_json(port: int, route: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as resp:
        return json.load(resp)


def phase_operator_request(workdir: str, card: dict) -> dict:
    """A user's request for this card through the port's operator
    (docstring, phase 21). Returns the running operator and what it
    composed; ``operator_request_busy`` stops it."""
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.api import Node, ObjectMeta
    from tpu_composer_torch.controllers import (
        ComposabilityRequestReconciler, ComposableResourceReconciler,
        RequestTiming, ResourceTiming)
    from tpu_composer_torch.fabric.inmem import InMemoryPool
    from tpu_composer_torch.runtime import Manager, Store
    from tpu_composer_torch.scheduler import ClusterScheduler, native

    root = os.path.join(workdir, "operator_request")
    agent = LocalNodeAgent(cdi_dir=os.path.join(root, "cdi"),
                           state_dir=os.path.join(root, "state"))
    driver = agent.ensure_driver("localhost")
    gpus = agent.gpus()
    check(gpus, "the node agent lists no GPU on this host")
    store = Store()
    node = Node(metadata=ObjectMeta(name="localhost"))
    node.status.tpu_slots = len(gpus)
    store.create(node)
    pool = InMemoryPool()
    sched = ClusterScheduler(store, native_sched=True)
    check(sched.engine.kernel_kind == "native",
          f"the scheduler runs {sched.engine.kernel_kind}, not the native scan")
    req_rec = ComposabilityRequestReconciler(
        store, pool, scheduler=sched,
        timing=RequestTiming(updating_poll=0.05, cleaning_poll=0.05))
    mgr = Manager(store=store, health_addr="127.0.0.1:0",
                  decisions=sched.ledger)
    mgr.add_controller(req_rec)
    mgr.add_controller(ComposableResourceReconciler(
        store, pool, agent, decision_ledger=sched.ledger,
        timing=ResourceTiming(attach_poll=0.05, visibility_poll=0.05)))
    mgr.start(workers_per_controller=2)
    try:
        out = _request_and_check(store, pool, agent, sched, mgr, gpus,
                                 driver, card)
        out["native_build_s"] = native.build_log.get("tpusched", (0.0,))[0]
        out["native_lib"] = os.path.relpath(native.library_path(), HERE)
    except BaseException:
        mgr.stop()
        raise
    emit("operator_request", **{k: v for k, v in out.items()
                                if k not in ("agent",)})
    return {"manager": mgr, **out}


def _request_and_check(store, pool, agent, sched, mgr, gpus, driver,
                       card) -> dict:
    from tpu_composer_torch.admission import slice_env
    from tpu_composer_torch.agent.cdi import spec_path
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposabilityRequestSpec, ComposableResource,
        ObjectMeta, ResourceDetails)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.runtime import tracing

    def submit(name):
        store.create(ComposabilityRequest(
            metadata=ObjectMeta(name=name),
            spec=ComposabilityRequestSpec(resource=ResourceDetails(
                type="gpu", model=H100_MODEL, size=1))))

    name, slice_name = "chip-smoke", "chip-smoke-slice"
    t0 = time.perf_counter()
    submit(name)
    deadline = t0 + 30.0
    while True:
        req = store.get(ComposabilityRequest, name)
        if req.status.state == "Running" or time.perf_counter() > deadline:
            break
        time.sleep(0.002)
    running_ms = (time.perf_counter() - t0) * 1e3
    check(req.status.state == "Running",
          f"the request is not Running after 30 s: {req.status.to_dict()}")
    want_slice = dict(name=slice_name, topology="1x1", num_hosts=1,
                      chips_per_host=1, worker_hostnames=["localhost"])
    check(req.status.slice.to_dict() == want_slice,
          f"status.slice {req.status.slice.to_dict()} != {want_slice}")
    reserved = pool._slices.get(slice_name)
    check(reserved is not None and reserved.nodes == ["localhost"]
          and reserved.model == H100_MODEL and reserved.topology == "1x1",
          f"the pool holds no reservation {slice_name} on localhost:"
          f" {sorted(pool._slices)}")
    children = store.list(ComposableResource,
                          label_selector={LABEL_MANAGED_BY: name})
    check(len(children) == 1, f"{len(children)} children, not 1")
    (child,) = children
    check(child.status.state == "Online" and child.spec.chip_count == 1
          and child.spec.slice_name == slice_name,
          f"the child is not one Online GPU of {slice_name}:"
          f" {child.spec.to_dict()} {child.status.to_dict()}")
    group = f"{slice_name}-worker{child.spec.worker_id}"
    check(agent.check_visible("localhost", child.status.device_ids,
                              group=group),
          "the request's GPU does not enumerate on the host")

    hand = _compose_one_gpu(slice_name)
    path = spec_path(agent.cdi_dir, hand)
    check(os.path.exists(path), f"no CDI spec at {path}")
    with open(path) as f:
        doc = json.load(f)
    edits = doc["devices"][0]["containerEdits"]
    spec_env = dict(e.split("=", 1) for e in edits["env"])
    want_env = slice_env(req.status.slice, child.spec.worker_id, H100_MODEL)
    check(spec_env == want_env,
          f"the child's spec env {spec_env} != slice_env {want_env}")
    check(spec_env == hand.env,
          f"the child's spec env {spec_env} != the hand composition's"
          f" {hand.env}")
    nodes = [n["path"] for n in edits["deviceNodes"]]
    gpu_nodes = [n for n in nodes if _gpu_node_minor(n) is not None]
    cuda_nodes = _cuda_nodes()
    check(len(gpu_nodes) == 1 and gpu_nodes == cuda_nodes,
          f"the spec's GPU node {gpu_nodes} is not the card CUDA holds open"
          f" {cuda_nodes}")
    scan = sched.engine.last_scan_kind
    check(scan == "native", f"the placement ran the {scan} scan")

    explain = _get_json(mgr.health_port,
                        f"/debug/scheduler/explain/{name}")
    latest = explain["latest"]
    check(latest["outcome"] == "placed" and latest["chosen"] == ["localhost"],
          f"the explain route's decision does not place on localhost: {latest}")
    spans = [e for e in tracing.trace_events(latest["decision_id"])
             if e.get("ph") == "X" and e.get("name") == "scheduler.decide"]
    check(spans, "the placement decision left no scheduler.decide span")
    decide_ms = spans[0]["dur"] / 1e3

    # A second request: the host's one GPU is taken.
    submit("chip-smoke-2")
    deadline = time.perf_counter() + 30.0
    while True:
        second = store.get(ComposabilityRequest, "chip-smoke-2")
        led = sched.ledger.latest("chip-smoke-2")
        if (second.status.error and led is not None) or \
                time.perf_counter() > deadline:
            break
        time.sleep(0.002)
    check(second.status.state in ("", "NodeAllocating")
          and not store.list(ComposableResource,
                             label_selector={LABEL_MANAGED_BY: "chip-smoke-2"}),
          f"the second request was placed: {second.status.to_dict()}")
    held = _get_json(mgr.health_port,
                     "/debug/scheduler/explain/chip-smoke-2")["latest"]
    verdicts = {c["node"]: c["verdict"] for c in held.get("candidates", ())}
    check(held["outcome"] == "held-back"
          and verdicts.get("localhost") == "no-tpu-ports free=0 need=1",
          f"the second request's record: {held}")
    return {"agent": agent, "group": group, "slice": slice_name,
            "device_ids": list(child.status.device_ids), "env": spec_env,
            "cdi": child.status.cdi_device_id, "device_nodes": nodes,
            "request_to_running_host_ms": running_ms,
            "placement_decision_ms": decide_ms, "scan_kind": scan,
            "card": card["nvidia_smi"], "driver": driver, "gpus": len(gpus),
            "spec": doc["devices"][0]["name"], "cuda_nodes": cuda_nodes,
            "child": child.metadata.name, "chip_indices": child.status.chip_indices,
            "explain": {"outcome": latest["outcome"], "chosen": latest["chosen"],
                        "engine": explain.get("engine"),
                        "nonces": len(latest.get("nonces", ()))},
            "second": {"error": second.status.error,
                       "outcome": held["outcome"], "verdicts": verdicts,
                       "binding": held.get("binding")}}


REMOTE_BACKENDS = ("REST_CM", "REST_FM", "LAYOUT", "REDFISH")
#: The backend whose child's spec env the composed worker runs from.
WORKER_BACKEND = "REST_CM"


def _fake_fabric_module():
    """``tests/torch_fake_fabric.py`` of this checkout, loaded by path (a
    ``tests`` package elsewhere on the path must not shadow it)."""
    import importlib.util

    path = os.path.join(HERE, "tests", "torch_fake_fabric.py")
    check(os.path.exists(path), f"no fake fabric server at {path}")
    spec = importlib.util.spec_from_file_location("torch_fake_fabric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fabric_calls() -> dict:
    from tpu_composer_torch.runtime.metrics import fabric_calls_total

    return {f"{ls['verb']}/{'group' if ls['batched'] == 'true' else 'single'}":
            fabric_calls_total.value(**ls)
            for ls in fabric_calls_total.label_sets()}


def _remote_operator(kind: str, workdir: str, server) -> dict:
    """One operator composing through ``kind`` against ``server``: the
    provider from ``new_fabric_provider`` (behind the breaker, the token
    path on), a ``FabricDispatcher`` in front of both reconcilers and the
    Manager, and for REST_CM a ``FabricSession`` on the server's
    ``/v1/events``. Returns the running pieces."""
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.api import Node, ObjectMeta
    from tpu_composer_torch.controllers import (
        ComposabilityRequestReconciler, ComposableResourceReconciler,
        RequestTiming, ResourceTiming)
    from tpu_composer_torch.controllers.adoption import adopt_pending_ops
    from tpu_composer_torch.fabric import (
        BreakerFabricProvider, FabricDispatcher, FabricSession,
        new_fabric_provider)
    from tpu_composer_torch.runtime import Manager, Store
    from tpu_composer_torch.scheduler import ClusterScheduler

    env = {"FABRIC_ENDPOINT": server.url, "FABRIC_AUTH_URL": server.token_url,
           "FABRIC_USERNAME": server.username,
           "FABRIC_PASSWORD": server.password}
    saved = {k: os.environ.get(k) for k in (*env, "TPU_COMPOSER_BREAKER")}
    os.environ.update(env)
    os.environ.pop("TPU_COMPOSER_BREAKER", None)
    try:
        fabric = new_fabric_provider(kind)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(isinstance(fabric, BreakerFabricProvider),
          f"{kind}: the provider is {type(fabric).__name__}, not behind the"
          " breaker")
    root = os.path.join(workdir, f"operator_{kind.lower()}")
    agent = LocalNodeAgent(cdi_dir=os.path.join(root, "cdi"),
                           state_dir=os.path.join(root, "state"))
    driver = agent.ensure_driver("localhost")
    gpus = agent.gpus()
    check(gpus, "the node agent lists no GPU on this host")
    store = Store()
    node = Node(metadata=ObjectMeta(name="localhost"))
    node.status.tpu_slots = len(gpus)
    store.create(node)
    sched = ClusterScheduler(store, native_sched=True)
    check(sched.engine.kernel_kind == "native",
          f"the scheduler runs {sched.engine.kernel_kind}, not the native scan")
    disp = FabricDispatcher(fabric, batch_window=0.005, poll_interval=0.05)
    session = None
    if kind == "REST_CM":
        session = FabricSession(fabric, poll_timeout=0.5, name=server.url)
        disp.attach_session(session)
    mgr = Manager(store=store, dispatcher=disp)
    mgr.add_controller(ComposabilityRequestReconciler(
        store, fabric, scheduler=sched,
        timing=RequestTiming(updating_poll=0.05, cleaning_poll=0.05)))
    mgr.add_controller(ComposableResourceReconciler(
        store, fabric, agent, decision_ledger=sched.ledger, dispatcher=disp,
        timing=ResourceTiming(attach_poll=0.05, visibility_poll=0.05)))
    mgr.add_runnable(disp.run)
    if session is not None:
        mgr.add_runnable(session.run)
    mgr.add_startup_hook(lambda: adopt_pending_ops(store, fabric, disp))
    return {"kind": kind, "manager": mgr, "server": server, "store": store,
            "agent": agent, "sched": sched, "session": session,
            "dispatcher": disp, "driver": driver, "gpus": gpus}


def _remote_request_and_check(op: dict, card: dict) -> dict:
    """A user's request for one H100 through one remote operator, held
    to the hand composition and the card CUDA runs on."""
    from tpu_composer_torch.admission import slice_env
    from tpu_composer_torch.agent.cdi import spec_path
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposabilityRequestSpec, ComposableResource,
        ObjectMeta, ResourceDetails)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY

    kind, store, server, agent = op["kind"], op["store"], op["server"], op["agent"]
    name, slice_name = "chip-smoke", "chip-smoke-slice"
    calls0 = _fabric_calls()
    t0 = time.perf_counter()
    store.create(ComposabilityRequest(
        metadata=ObjectMeta(name=name),
        spec=ComposabilityRequestSpec(resource=ResourceDetails(
            type="gpu", model=H100_MODEL, size=1))))
    deadline = t0 + 30.0
    while True:
        req = store.get(ComposabilityRequest, name)
        kids = store.list(ComposableResource,
                          label_selector={LABEL_MANAGED_BY: name})
        if (req.status.state == "Running" and len(kids) == 1
                and kids[0].status.state == "Online") \
                or time.perf_counter() > deadline:
            break
        time.sleep(0.002)
    running_ms = (time.perf_counter() - t0) * 1e3
    check(req.status.state == "Running" and len(kids) == 1
          and kids[0].status.state == "Online",
          f"{kind}: the request is not Running with its child Online after"
          f" 30 s: {req.status.to_dict()}"
          f" {[k.status.to_dict() for k in kids]}")
    want_slice = dict(name=slice_name, topology="1x1", num_hosts=1,
                      chips_per_host=1, worker_hostnames=["localhost"])
    check(req.status.slice.to_dict() == want_slice,
          f"{kind}: status.slice {req.status.slice.to_dict()} != {want_slice}")
    reserved = server.pool._slices.get(slice_name)
    check(reserved is not None and reserved.nodes == ["localhost"]
          and reserved.model == H100_MODEL,
          f"{kind}: the fabric holds no reservation {slice_name}:"
          f" {sorted(server.pool._slices)}")
    (child,) = kids
    group = f"{slice_name}-worker{child.spec.worker_id}"
    check(agent.check_visible("localhost", child.status.device_ids,
                              group=group),
          f"{kind}: the request's GPU does not enumerate on the host")
    hand = _compose_one_gpu(slice_name)
    check(child.status.cdi_device_id == hand.qualified_name,
          f"{kind}: the fabric's CDI id {child.status.cdi_device_id} !="
          f" {hand.qualified_name}")
    path = spec_path(agent.cdi_dir, hand)
    check(os.path.exists(path), f"{kind}: no CDI spec at {path}")
    with open(path) as f:
        doc = json.load(f)
    edits = doc["devices"][0]["containerEdits"]
    spec_env = dict(e.split("=", 1) for e in edits["env"])
    check(spec_env == hand.env == slice_env(req.status.slice, 0, H100_MODEL),
          f"{kind}: the child's spec env {spec_env} != the hand"
          f" composition's {hand.env}")
    nodes = [n["path"] for n in edits["deviceNodes"]]
    gpu_nodes = [n for n in nodes if _gpu_node_minor(n) is not None]
    check(nodes[1:] == hand.device_nodes[1:],
          f"{kind}: the spec's control nodes {nodes[1:]} !="
          f" {hand.device_nodes[1:]}")
    cuda_nodes = _cuda_nodes()
    check(len(gpu_nodes) == 1 and gpu_nodes == cuda_nodes,
          f"{kind}: the spec's GPU node {gpu_nodes} is not the card CUDA"
          f" holds open {cuda_nodes}")
    scan = op["sched"].engine.last_scan_kind
    check(scan == "native", f"{kind}: the placement ran the {scan} scan")
    check(server.token_requests >= 1,
          f"{kind}: no token was fetched: the token path was not on the wire")
    calls = {k: v - calls0.get(k, 0.0) for k, v in _fabric_calls().items()
             if v != calls0.get(k, 0.0)}
    check(calls.get("add/single", 0) + calls.get("add/group", 0) >= 1,
          f"{kind}: the attach did not go through the dispatcher: {calls}")
    wire = {}
    for line in server.request_log:
        method, route = line.split(" ", 1)
        parts = route.strip("/").split("/")
        key = f"{method} /" + "/".join(parts[:3 if parts[0] == "redfish" else 2])
        wire[key] = wire.get(key, 0) + 1
    rec = {"request_to_running_host_ms": running_ms,
           "wire_requests": len(server.request_log), "wire": wire,
           "token_fetches": server.token_requests,
           "dispatcher_calls": calls, "scan_kind": scan,
           "device_ids": list(child.status.device_ids),
           "chip_indices": list(child.status.chip_indices),
           "cdi": child.status.cdi_device_id, "device_nodes": nodes,
           "cuda_nodes": cuda_nodes, "spec": doc["devices"][0]["name"],
           "child": child.metadata.name}
    session = op["session"]
    if session is not None:
        check(session.healthy() and session.supported(),
              f"{kind}: the event session is not streaming")
        rec["session"] = {"events_seen": session.events_seen,
                          "cursor": session.cursor(), "gaps": session.gaps}
    return {"group": group, "slice": slice_name, "env": spec_env,
            "device_ids": list(child.status.device_ids), "rec": rec}


def _stop_remote(op: dict) -> None:
    """Stop one remote operator (its Manager drains the dispatcher), then
    its fake fabric server."""
    try:
        op["manager"].stop()
    finally:
        op["server"].close()


def phase_operator_remote(workdir: str, card: dict) -> dict:
    """The port's operator composes this card through each remote fabric
    backend (docstring, phase 22). Returns the REST_CM operator, still
    running, and every backend's record; ``operator_remote_busy`` stops
    it."""
    from tpu_composer_torch.fabric import InMemoryPool
    from tpu_composer_torch.runtime.metrics import dispatcher_drains_total

    fake = _fake_fabric_module()
    ops, records, kept = {}, {}, None
    try:
        for kind in REMOTE_BACKENDS:
            server = fake.FakeFabricServer(pool=InMemoryPool(),
                                           require_auth=True)
            try:
                op = _remote_operator(kind, workdir, server)
            except BaseException:
                server.close()
                raise
            ops[kind] = op
            op["manager"].start(workers_per_controller=2)
            if op["session"] is not None:
                deadline = time.perf_counter() + 10.0
                while not op["session"].healthy() and \
                        time.perf_counter() < deadline:
                    time.sleep(0.005)
                check(op["session"].healthy(),
                      f"{kind}: the event session never connected")
            got = _remote_request_and_check(op, card)
            records[kind] = got["rec"]
            if kind == WORKER_BACKEND:
                kept = {**op, **got}
            else:
                clean0 = dispatcher_drains_total.value(outcome="clean")
                _stop_remote(ops.pop(kind))
                records[kind]["drains_clean"] = (
                    dispatcher_drains_total.value(outcome="clean") - clean0)
                check(records[kind]["drains_clean"] == 1,
                      f"{kind}: stopping the operator drained no dispatcher")
    except BaseException:
        for op in ops.values():
            _stop_remote(op)
        raise
    emit("operator_remote", card=card["nvidia_smi"], backends=records,
         worker_backend=WORKER_BACKEND)
    rest = records[WORKER_BACKEND]
    return {**kept, "cdi": rest["cdi"], "device_nodes": rest["device_nodes"],
            "backends": records}


def phase_operator_remote_busy(operator: dict) -> dict:
    """The busy guard on the REST_CM operator's group, then that operator
    stops: its Manager drains the dispatcher (docstring, phase 25)."""
    from tpu_composer_torch.runtime.metrics import dispatcher_drains_total

    clean0 = dispatcher_drains_total.value(outcome="clean")
    try:
        out = phase_operator_busy(operator, "operator_remote_busy")
    finally:
        operator["server"].close()
    drained = dispatcher_drains_total.value(outcome="clean") - clean0
    check(drained == 1, f"the REST_CM operator's stop drained {drained}"
          " dispatchers, not 1")
    emit("operator_remote_busy", check="drain", drains_clean=drained)
    return {**out, "drains_clean": drained}


# The HA operator's world (phases 26 and 27): the reference's failover
# world of 3 replicas over K = 6 shards, with short lease timings.
HA_REPLICAS = ("replica-a", "replica-b", "replica-c")
HA_SHARDS = 6
HA_LEASE_S = 3.0
HA_RENEW_S = 0.25
HA_RENEW_DEADLINE_S = 2.0
HA_BREAKER = dict(failure_threshold=3, reset_timeout=0.5, resync_rate=50.0,
                  resync_window=1.0)
HA_BLACKOUT_S = 1.0


class _CrashFuse:
    """Store facade of a crashed replica (the reference's CrashFuse,
    ``tests/test_crash_restart.py:128``): from ``die()`` on, every call
    raises ``StoreError`` and the watch streams go silent, so the
    replica's informer cache keeps what it last saw."""

    def __init__(self, inner):
        self._inner = inner
        self.dead = False

    def die(self):
        self.dead = True

    def _gate(self):
        if self.dead:
            from tpu_composer_torch.runtime.store import StoreError

            raise StoreError("crash: process dead")

    def create(self, obj):
        self._gate()
        return self._inner.create(obj)

    def get(self, cls, name):
        self._gate()
        return self._inner.get(cls, name)

    def try_get(self, cls, name):
        self._gate()
        return self._inner.try_get(cls, name)

    def list(self, cls, label_selector=None):
        self._gate()
        return self._inner.list(cls, label_selector)

    def update(self, obj):
        self._gate()
        return self._inner.update(obj)

    def update_status(self, obj):
        self._gate()
        return self._inner.update_status(obj)

    def delete(self, cls, name):
        self._gate()
        return self._inner.delete(cls, name)

    def watch(self, kind=None):
        return _FusedWatch(self._inner.watch(kind), self)

    def stop_watch(self, q):
        self._inner.stop_watch(getattr(q, "_q", q))

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)


class _FusedWatch:
    """A watch queue that drops the store's events once its fuse is dead
    (control items still pass)."""

    def __init__(self, q, fuse):
        self._q, self._fuse = q, fuse

    def get(self, block: bool = True, timeout=None):
        from tpu_composer_torch.runtime.store import WatchEvent

        while True:
            item = self._q.get(block, timeout)
            if isinstance(item, WatchEvent) and self._fuse.dead:
                continue
            return item

    def __getattr__(self, name):
        return getattr(self.__dict__["_q"], name)


class _CountingFabric:
    """One replica's view of the shared pool: counts the mutating verbs
    this replica issues."""

    _MUTATING = ("add_resource", "remove_resource", "add_resources",
                 "remove_resources", "reserve_slice", "release_slice",
                 "resize_slice", "repair_slice_member")

    def __init__(self, pool):
        self._pool = pool
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self.__dict__["_pool"], name)
        if name not in type(self)._MUTATING:
            return attr

        def counted(*args, **kwargs):
            self.calls.append(name)
            return attr(*args, **kwargs)

        return counted


def _recording_pool():
    """An ``InMemoryPool`` that logs each attachment it materializes with
    the intent nonce behind it, and each release."""
    from tpu_composer_torch.fabric.inmem import InMemoryPool

    class RecordingPool(InMemoryPool):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.events = []

        def _add_one_locked(self, resource):
            name = resource.metadata.name
            before = name in self._attachments
            out = super()._add_one_locked(resource)
            if not before and name in self._attachments:
                po = resource.status.pending_op
                self.events.append(("attach", name, po.nonce if po else ""))
            return out

        def _remove_one_locked(self, resource):
            name = resource.metadata.name
            before = name in self._attachments
            super()._remove_one_locked(resource)
            if before and name not in self._attachments:
                self.events.append(("release", name))

    # Two fabric re-polls per attach: the crash has a window to land in.
    return RecordingPool(async_steps=2)


def _ha_replica(ident: str, store, chaos, pool, agent, reports: list) -> dict:
    """One operator replica wired as the reference's entry point wires
    ``--shards K``: its own crash fuse over the shared (chaos-wrapped)
    store, a store breaker under a ``CachedClient``, a ``ShardLeaseElector``
    on the fuse (leases need linearizable reads), a ``FabricDispatcher``
    gated by ``owns=``, the native-scan scheduler, both reconcilers with
    ``ownership=``, the overload governor with its shed gate, the
    watchdog, and the shard hooks: scoped adoption on acquire, a resync
    on ready, lane fencing on lose. The scheduler's snapshot follows the
    shared store's own watch: the native scan declines a chaos-wrapped
    source, whose watch may drop events (this one drops none)."""
    from tpu_composer_torch.controllers import (
        ComposabilityRequestReconciler, ComposableResourceReconciler,
        RequestTiming, ResourceTiming)
    from tpu_composer_torch.controllers.adoption import adopt_pending_ops
    from tpu_composer_torch.fabric import FabricDispatcher
    from tpu_composer_torch.runtime import Manager
    from tpu_composer_torch.runtime.cache import CachedClient
    from tpu_composer_torch.runtime.overload import (
        OverloadGovernor, request_shed_gate)
    from tpu_composer_torch.runtime.shards import ShardLeaseElector, shard_for
    from tpu_composer_torch.runtime.storebreaker import BreakingStore
    from tpu_composer_torch.runtime.watchdog import Watchdog
    from tpu_composer_torch.scheduler import ClusterScheduler

    fuse = _CrashFuse(chaos)
    breaker = BreakingStore(fuse, **HA_BREAKER)
    client = CachedClient(breaker)
    elector = ShardLeaseElector(
        fuse, HA_SHARDS, identity=ident, lease_duration_s=HA_LEASE_S,
        renew_period_s=HA_RENEW_S, renew_deadline_s=HA_RENEW_DEADLINE_S,
        expected_replicas=len(HA_REPLICAS))
    own = elector.ownership
    fabric = _CountingFabric(pool)
    disp = FabricDispatcher(fabric, batch_window=0.005, poll_interval=0.05,
                            owns=own.owns_key)
    sched = ClusterScheduler(store, native_sched=True)
    check(sched.engine.kernel_kind == "native",
          f"{ident}: the scheduler runs {sched.engine.kernel_kind}")
    watchdog = Watchdog(stall_after=30.0, restart_budget=3)
    disp.watchdog = watchdog
    governor = OverloadGovernor(period=0.25, shed_quantum=1.0,
                                ledger=sched.ledger, store_breaker=breaker)
    governor.watchdog = watchdog
    mgr = Manager(store=client, leader_elector=elector,
                  health_addr="127.0.0.1:0", dispatcher=disp,
                  decisions=sched.ledger, replica_id=ident,
                  overload=governor, watchdog=watchdog, storebreaker=breaker)
    watchdog.recorder = governor.recorder = mgr.recorder
    req_rec = ComposabilityRequestReconciler(
        client, fabric, scheduler=sched, ownership=own,
        timing=RequestTiming(updating_poll=0.05, cleaning_poll=0.05))
    res_rec = ComposableResourceReconciler(
        client, fabric, agent, decision_ledger=sched.ledger, dispatcher=disp,
        ownership=own,
        timing=ResourceTiming(attach_poll=0.05, visibility_poll=0.05))
    req_rec.shed_gate = request_shed_gate(governor, client)
    for c in (req_rec, res_rec):
        mgr.add_controller(c)
        governor.add_queue(lambda c=c: len(c.queue))
        c.watchdog = watchdog
    governor.stretch(sched.ledger, "hold_rescan_s")
    watchdog.register("OverloadGovernor", stall_after=30.0, restartable=True)
    mgr.add_runnable(disp.run)
    mgr.add_runnable(watchdog.run)
    mgr.add_runnable(governor.run)
    elector.on_acquire.append(lambda wins: reports.append(
        (ident, dict(wins), adopt_pending_ops(
            client, fabric, disp, shards=set(wins), num_shards=HA_SHARDS))))
    elector.on_ready.append(lambda shards: mgr.resync(
        lambda key, _s=frozenset(shards): shard_for(key, HA_SHARDS) in _s))
    elector.on_lose.append(lambda shard, reason: disp.abandon_unowned())
    return {"ident": ident, "fuse": fuse, "breaker": breaker,
            "client": client, "elector": elector, "fabric": fabric,
            "dispatcher": disp, "sched": sched, "manager": mgr,
            "req_rec": req_rec, "res_rec": res_rec, "governor": governor,
            "watchdog": watchdog}


class _Managers:
    """Stops the HA phase's remaining managers together."""

    def __init__(self, replicas):
        self.replicas = replicas

    def stop(self):
        for r in self.replicas:
            r["manager"].stop()


def _wait(pred, timeout: float, interval: float = 0.002) -> bool:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            return False
        time.sleep(interval)
    return True


def _ha_worker_kernels(gen: torch.Generator,
                       phase: str = "operator_ha") -> dict:
    """The composed worker's first work: K1 without lse at the serving
    prefill shape and K2 at the dense engine's decode shape, each once,
    counted under ``phase`` (``operator_ha`` or ``operator_fleet``),
    against its plain version."""
    from tpu_composer_torch.ops.attention import (
        flash_fwd_cuda, flash_fwd_plain)
    from tpu_composer_torch.ops.paged_attention import (
        paged_decode_cuda, paged_decode_plain)

    dtype = torch.bfloat16
    q = torch.randn(1, 256, 8, 64, generator=gen).to("cuda", dtype)
    k = torch.randn(1, 256, 2, 64, generator=gen).to("cuda", dtype)
    v = torch.randn(1, 256, 2, 64, generator=gen).to("cuda", dtype)
    got, _ = flash_fwd_cuda(q, k, v, True)
    want, _ = flash_fwd_plain(q, k, v, True)
    args = _paged_inputs(gen, dtype, False)
    got2 = paged_decode_cuda(*args)
    want2 = paged_decode_plain(*args)
    torch.cuda.synchronize()
    e1, e2 = max_err(got, want), max_err(got2, want2)
    check(e1 <= TOL[dtype], f"{phase}: K1 error {e1}")
    check(e2 <= TOL[dtype], f"{phase}: K2 error {e2}")
    return {"flash_fwd": {"shape": [1, 256, 8, 2, 64], "dtype": "bfloat16",
                          "causal": True, "max_abs_err": e1},
            "paged_decode": {"shape": [8, 8, 2, 64, 16, 32], "dtype":
                             "bfloat16", "lengths": args[4].tolist(),
                             "max_abs_err": e2},
            "tol": TOL[dtype]}


def _ha_spec(agent, slice_name: str, child, req,
             phase: str = "operator_ha") -> dict:
    """The child's CDI spec, held to ``slice_env`` and the hand
    composition, its GPU node to the card CUDA holds."""
    from tpu_composer_torch.admission import slice_env
    from tpu_composer_torch.agent.cdi import spec_path

    hand = _compose_one_gpu(slice_name)
    path = spec_path(agent.cdi_dir, hand)
    check(os.path.exists(path), f"{phase}: no CDI spec at {path}")
    with open(path) as f:
        doc = json.load(f)
    edits = doc["devices"][0]["containerEdits"]
    spec_env = dict(e.split("=", 1) for e in edits["env"])
    want_env = slice_env(req.status.slice, child.spec.worker_id, H100_MODEL)
    check(spec_env == want_env == hand.env,
          f"{phase}: the child's spec env {spec_env} != slice_env"
          f" {want_env} or the hand composition's {hand.env}")
    nodes = [n["path"] for n in edits["deviceNodes"]]
    gpu_nodes = [n for n in nodes if _gpu_node_minor(n) is not None]
    cuda_nodes = _cuda_nodes()
    check(len(gpu_nodes) == 1 and gpu_nodes == cuda_nodes,
          f"{phase}: the spec's GPU node {gpu_nodes} is not the card"
          f" CUDA holds open {cuda_nodes}")
    return {"env": spec_env, "device_nodes": nodes, "cuda_nodes": cuda_nodes,
            "spec": doc["devices"][0]["name"]}


def phase_operator_ha(workdir: str, card: dict, gen: torch.Generator) -> dict:
    """The HA operator composes this card through a crash, a planned
    handoff and a store outage (docstring, phase 26). Returns the
    surviving replicas, still running, and the composed group;
    ``operator_ha_busy`` stops them."""
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposabilityRequestSpec, ComposableResource,
        Node, ObjectMeta, ResourceDetails)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.runtime import Store
    from tpu_composer_torch.runtime.cache import CachedClient
    from tpu_composer_torch.runtime.chaosstore import ChaosStore
    from tpu_composer_torch.runtime.metrics import (
        cached_reads_total, dispatcher_drains_total, store_requests_total)
    from tpu_composer_torch.runtime.shards import ShardFencedError, shard_for

    root = os.path.join(workdir, "operator_ha")
    # One node agent for the node: the replicas share its CDI and state
    # directories, as replicas on one host share the node's.
    agent = LocalNodeAgent(cdi_dir=os.path.join(root, "cdi"),
                           state_dir=os.path.join(root, "state"))
    agent.ensure_driver("localhost")
    gpus = agent.gpus()
    check(gpus, "the node agent lists no GPU on this host")
    store = Store()
    node = Node(metadata=ObjectMeta(name="localhost"))
    node.status.tpu_slots = len(gpus)
    store.create(node)
    chaos = ChaosStore(store)
    pool = _recording_pool()
    # The phase watches through a cache of its own, so its polling adds
    # no store round trips to the operator's.
    obs = CachedClient(store)
    reports = []
    replicas = []

    def rtts():
        return {f"{ls['verb']} {ls['kind']}": store_requests_total.value(**ls)
                for ls in store_requests_total.label_sets()
                if ls["kind"] != "Lease"}

    try:
        for ident in HA_REPLICAS:
            r = _ha_replica(ident, store, chaos, pool, agent, reports)
            replicas.append(r)
            r["manager"].start(workers_per_controller=2)
        owned = lambda r: set(r["elector"].owned_shards())  # noqa: E731
        check(_wait(lambda: sorted(len(owned(r)) for r in replicas)
                    == [2, 2, 2], 10.0),
              "operator_ha: the shards never balanced:"
              f" {[sorted(owned(r)) for r in replicas]}")
        bootstrap = {r["ident"]: sorted(owned(r)) for r in replicas}

        def owner_of(key, among):
            shard = shard_for(key, HA_SHARDS)
            return next((r for r in among if shard in owned(r)), None)

        def submit(name):
            store.create(ComposabilityRequest(
                metadata=ObjectMeta(name=name),
                spec=ComposabilityRequestSpec(resource=ResourceDetails(
                    type="gpu", model=H100_MODEL, size=1))))

        name, slice_name = "chip-smoke-ha", "chip-smoke-ha-slice"
        victim = owner_of(name, replicas)
        obs.list(ComposabilityRequest)
        obs.list(ComposableResource)
        rtt0, cached0 = rtts(), cached_reads_total.total()
        phase_reads = [0]
        submit(name)

        def mid_attach():
            # As the victim sees it: the crash freezes its cache there.
            phase_reads[0] += 1
            kids = victim["client"].list(
                ComposableResource, label_selector={LABEL_MANAGED_BY: name})
            return [k for k in kids if k.status.pending_op is not None
                    and k.status.state != "Online"]

        check(_wait(lambda: mid_attach(), 30.0, 0.0005),
              "operator_ha: no child ever carried an attach intent")
        victim["fuse"].die()
        victim["dispatcher"].kill()
        t_crash = time.perf_counter()
        (caught,) = mid_attach() or [None]
        check(caught is not None, "operator_ha: the child went Online before"
              " the crash")
        crash_state = {"child": caught.metadata.name,
                       "state": caught.status.state,
                       "pending_op": caught.status.pending_op.verb,
                       "device_ids": list(caught.status.device_ids),
                       "child_owner": (owner_of(caught.metadata.name,
                                                replicas) or {}).get("ident"),
                       "request_owner": victim["ident"]}
        emit("operator_ha", check="crash", **crash_state)
        lost = sorted(owned(victim))
        survivors = [r for r in replicas if r is not victim]

        # The crashed replica's renew loop cannot list its leases: it
        # fences its shards at the renew deadline. Its own reconcile of
        # the child is then refused at the fabric boundary.
        check(_wait(lambda: not owned(victim), HA_LEASE_S + 5.0),
              f"operator_ha: the crashed replica never fenced {lost}")
        fenced_ms = (time.perf_counter() - t_crash) * 1e3
        calls0 = len(victim["fabric"].calls)
        try:
            victim["res_rec"].reconcile(caught.metadata.name)
            fence = "returned"
        except ShardFencedError as e:
            fence = f"ShardFencedError: {e}"
        except Exception as e:  # noqa: BLE001 - named in the failure
            fence = f"{type(e).__name__}: {e}"
        hand_calls = len(victim["fabric"].calls) - calls0
        check(fence.startswith("ShardFencedError") and hand_calls == 0,
              f"operator_ha: the crashed replica's reconcile gave {fence}"
              f" with {hand_calls} fabric calls")

        check(_wait(lambda: owner_of(name, survivors) is not None,
                    HA_LEASE_S + 30.0),
              "operator_ha: no survivor took the request's shard")
        acquired_ms = (time.perf_counter() - t_crash) * 1e3

        def running():
            phase_reads[0] += 2
            req = obs.get(ComposabilityRequest, name)
            kids = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
            return (req.status.state == "Running" and len(kids) == 1
                    and kids[0].status.state == "Online")

        check(_wait(running, HA_LEASE_S + 30.0),
              "operator_ha: the request never reached Running through a"
              " survivor")
        running_ms = (time.perf_counter() - t_crash) * 1e3
        rtt1 = rtts()
        round_trips = {k: v - rtt0.get(k, 0.0) for k, v in rtt1.items()
                       if v != rtt0.get(k, 0.0)}
        cached = cached_reads_total.total() - cached0 - phase_reads[0]
        check(set(lost) <= set().union(*(owned(r) for r in survivors)),
              f"operator_ha: the survivors never took all of {lost}")
        req = obs.get(ComposabilityRequest, name)
        (child,) = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
        check(child.spec.slice_name == slice_name
              and child.spec.chip_count == 1,
              f"operator_ha: the child is not one GPU of {slice_name}:"
              f" {child.spec.to_dict()}")
        group = f"{slice_name}-worker{child.spec.worker_id}"
        check(agent.check_visible("localhost", child.status.device_ids,
                                  group=group),
              "operator_ha: the request's GPU does not enumerate on the host")
        spec = _ha_spec(agent, slice_name, child, req)
        check(sorted(pool._slices) == [slice_name],
              f"operator_ha: the pool holds {sorted(pool._slices)}, not one"
              f" reservation {slice_name}")
        attaches = [ev for ev in pool.events if ev[0] == "attach"]
        check([ev[1] for ev in attaches] == [child.metadata.name]
              and not [ev for ev in pool.events if ev[0] == "release"],
              f"operator_ha: the pool's attach log {pool.events} is not one"
              " attach of the child")
        adopted = [(ident, sorted(wins.items()), rep.total)
                   for ident, wins, rep in reports
                   if ident != victim["ident"] and "failover" in wins.values()]
        worker = _ha_worker_kernels(gen)

        # A planned stop of the survivor that owns the request's shard,
        # once the survivors have rebalanced (a shed in flight would hand
        # the shard over before the stop).
        check(_wait(lambda: sorted(len(owned(r)) for r in survivors)
                    == [3, 3], HA_LEASE_S + 5.0),
              "operator_ha: the survivors never rebalanced:"
              f" {[sorted(owned(r)) for r in survivors]}")
        rebalanced = {r["ident"]: sorted(owned(r)) for r in survivors}
        owner = owner_of(name, survivors)
        third = next(r for r in survivors if r is not owner)
        shard = shard_for(name, HA_SHARDS)
        stamps = {}
        release = owner["elector"].release

        def timed_release():
            stamps["released"] = time.perf_counter()
            release()

        owner["elector"].release = timed_release
        third["elector"].on_acquire.append(
            lambda wins: shard in wins
            and stamps.setdefault("acquired", time.perf_counter()))
        drains0 = dispatcher_drains_total.value(outcome="clean")
        owner["manager"].stop()
        drains = dispatcher_drains_total.value(outcome="clean") - drains0
        check(drains == 1, f"operator_ha: the planned stop drained {drains}"
              " dispatchers, not 1")
        check(_wait(lambda: "acquired" in stamps, 5.0),
              "operator_ha: the third replica never took the shard")
        handoff_ms = (stamps["acquired"] - stamps["released"]) * 1e3
        check(handoff_ms <= HA_RENEW_S * 1e3 + 50.0,
              f"operator_ha: the handoff took {handoff_ms:.1f} ms, more than"
              f" one renew period ({HA_RENEW_S * 1e3:.0f} ms)")
        check(running(), "operator_ha: the request left Running in the"
              " handoff")

        # The third replica serves every shard before the outage.
        check(_wait(lambda: len(owned(third)) == HA_SHARDS, HA_LEASE_S + 5.0),
              f"operator_ha: the third replica holds {sorted(owned(third))},"
              " not every shard")
        # One store outage, as a second request arrives: its first
        # reconciles' writes fail against the dark store and trip the
        # breaker, and it is queued once the store is back.
        second = "chip-smoke-ha-2"
        port = third["manager"].health_port

        def held_back():
            doc = _get_json(port, f"/debug/scheduler/explain/{second}")
            latest = doc.get("latest", {})
            verdicts = {c["node"]: c["verdict"]
                        for c in latest.get("candidates", ())}
            return (latest.get("outcome") == "held-back"
                    and verdicts.get("localhost")
                    == "no-tpu-ports free=0 need=1")

        trips0 = third["breaker"].snapshot()["trips"]
        chaos.blackout_for(HA_BLACKOUT_S)
        t_dark = time.perf_counter()
        submit(second)
        check(_wait(lambda: _get_json(port, "/debug/storebreaker")["trips"]
                    > trips0, HA_BLACKOUT_S + 5.0, 0.01),
              "operator_ha: the store breaker never tripped in the outage")
        tripped = _get_json(port, "/debug/storebreaker")
        check(_wait(lambda: _get_json(port, "/debug/storebreaker")["state"]
                    == "closed", 30.0, 0.01),
              "operator_ha: the store breaker never closed after the outage")
        closed_ms = (time.perf_counter() - t_dark) * 1e3
        healed = _get_json(port, "/debug/storebreaker")
        overload = _get_json(port, "/debug/overload")
        watchdog = _get_json(port, "/debug/watchdog")
        check(running(), "operator_ha: the request left Running in the"
              " outage")
        check(_wait(lambda: _try(held_back), 30.0, 0.01),
              "operator_ha: the second request never got its AllocationError"
              " hold-back record")
        queued_ms = (time.perf_counter() - t_dark) * 1e3
        held = _get_json(port, f"/debug/scheduler/explain/{second}")["latest"]
        second_req = obs.get(ComposabilityRequest, second)
        check(second_req.status.state in ("", "NodeAllocating")
              and second_req.status.error,
              f"operator_ha: the second request's status"
              f" {second_req.status.to_dict()}")
        check(not obs.list(ComposableResource,
                           label_selector={LABEL_MANAGED_BY: second}),
              "operator_ha: the second request got a child")
    except BaseException:
        for r in replicas:
            r["manager"].stop()
        raise
    finally:
        obs.stop_informers()
    rec = {"card": card["nvidia_smi"], "replicas": len(HA_REPLICAS),
           "shards": HA_SHARDS, "lease_duration_s": HA_LEASE_S,
           "renew_period_s": HA_RENEW_S,
           "renew_deadline_s": HA_RENEW_DEADLINE_S,
           "bootstrap": bootstrap, "crash": crash_state, "lost": lost,
           "crash_to_fenced_ms": fenced_ms,
           "crash_to_shard_acquired_ms": acquired_ms,
           "crash_to_running_ms": running_ms,
           "rebalanced": rebalanced,
           "graceful_handoff_ms": handoff_ms, "drains_clean": drains,
           "fence": fence, "fence_fabric_calls": hand_calls,
           "failover_adoptions": adopted,
           "store_round_trips_request_to_running": sum(round_trips.values()),
           "store_round_trips_by_verb": round_trips,
           "cached_reads_request_to_running": cached,
           "pool_events": pool.events, "slice": slice_name,
           "cdi": child.status.cdi_device_id, **spec,
           "worker_kernels": worker,
           "outage": {"blackout_s": HA_BLACKOUT_S, "tripped": tripped,
                      "closed_after_ms": closed_ms, "healed": healed,
                      "overload_state": overload["state_name"],
                      "watchdog_subsystems": sorted(watchdog["subsystems"]),
                      "second_queued_after_ms": queued_ms,
                      "second": {"error": second_req.status.error,
                                 "outcome": held["outcome"],
                                 "binding": held.get("binding")}}}
    emit("operator_ha", **{k: v for k, v in rec.items() if k != "env"},
         env=spec["env"])
    live = [r for r in replicas if r is not owner]
    return {"manager": _Managers(live), "agent": agent, "group": group,
            "device_ids": list(child.status.device_ids), **rec}


def _try(pred) -> bool:
    """``pred()``, False while the route it reads is not answering."""
    try:
        return pred()
    except OSError:
        return False


def phase_operator_ha_busy(operator: dict) -> dict:
    """The busy guard on the survivor's child group, then the surviving
    replicas stop (docstring, phase 27)."""
    return phase_operator_busy(operator, "operator_ha_busy")


FLEET_PUBLISH_S = 0.25
FLEET_STALE_S = 1.0
FLEET_SLO_EVAL_S = 0.25
FLEET_PING_S = 0.25
FLEET_DROP_S = 1.0
FLEET_PROXIED = "replica-c"


class _WireLog:
    """Counts one ``KubeStore``'s wire calls by verb (a watch open, and a
    watch resumed from a resourceVersion, apart from a plain GET)."""

    def __init__(self, store):
        self.calls = []
        real = store._request

        def logged(method, path, body=None, timeout=30.0, stream=False):
            self.calls.append((method, path, stream))
            return real(method, path, body, timeout, stream)

        store._request = logged

    @staticmethod
    def verb(method, path, stream) -> str:
        if not stream:
            return method
        return "WATCH resume" if "resourceVersion=" in path else "WATCH"

    def by_verb(self, since: int = 0) -> dict:
        out: dict = {}
        for call in self.calls[since:]:
            v = self.verb(*call)
            out[v] = out.get(v, 0) + 1
        return out


class _FrameCount:
    """Counts the ``tpuc-mux/1`` frames this process encodes, both sides
    (the replicas' clients and the apiserver's mux sessions), by wrapping
    the codec's ``encode_frame`` for the phase."""

    def __init__(self, wiremux):
        self._mod, self._real = wiremux, wiremux.encode_frame
        self._lock = threading.Lock()
        self.frames = {"client": 0, "server": 0}

    def _counted(self, obj):
        side = ("client" if "method" in obj or "ping" in obj
                or "cancel" in obj else "server")
        with self._lock:
            self.frames[side] += 1
        return self._real(obj)

    def start(self):
        self._mod.encode_frame = self._counted

    def stop(self):
        self._mod.encode_frame = self._real


class _Timed:
    """Wall ms of each call of one bound method, recorded in place."""

    def __init__(self, obj, name: str):
        self.ms = []
        real = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        setattr(obj, name, timed)

    def summary(self) -> dict:
        ms = sorted(self.ms)
        if not ms:
            return {"calls": 0}
        return {"calls": len(ms), "p50_ms": ms[len(ms) // 2],
                "max_ms": ms[-1], "mean_ms": sum(ms) / len(ms)}


def _fleet_replica(ident: str, url: str, pool, agent, reports: list) -> dict:
    """One operator replica over the apiserver's wire: its own
    ``KubeStore`` (the ``tpuc-mux/1`` transport, pinged every 0.25 s)
    behind a crash fuse, a ``CachedClient`` over the fuse, a
    ``ShardLeaseElector`` on the fuse, a ``FabricDispatcher`` with
    ``owns=``, both reconcilers with ``ownership=``, an ``SloEngine`` on
    the default objectives and a ``FleetPlane`` publishing through the
    fuse, all on one ``Manager`` with ``replica_id``, and the shard hooks
    of ``operator_ha`` (scoped adoption on acquire, a resync on ready,
    lane fencing on lose). The scheduler's
    native scan follows the ``KubeStore``'s own watch (the snapshot needs
    a lossless source; a fuse is none)."""
    from tpu_composer_torch.controllers import (
        ComposabilityRequestReconciler, ComposableResourceReconciler,
        RequestTiming, ResourceTiming)
    from tpu_composer_torch.controllers.adoption import adopt_pending_ops
    from tpu_composer_torch.fabric import FabricDispatcher
    from tpu_composer_torch.runtime import Manager
    from tpu_composer_torch.runtime.cache import CachedClient
    from tpu_composer_torch.runtime.fleet import FleetPlane
    from tpu_composer_torch.runtime.kubestore import KubeConfig, KubeStore
    from tpu_composer_torch.runtime.shards import ShardLeaseElector, shard_for
    from tpu_composer_torch.runtime.slo import SloEngine, default_objectives
    from tpu_composer_torch.scheduler import ClusterScheduler

    # Built in code: KubeConfig.from_kubeconfig needs PyYAML.
    wire = KubeStore(KubeConfig(host=url), cache_reads=False, wire_mux=True,
                     wire_ping_period=FLEET_PING_S, wire_ping_misses=2,
                     wire_connect_timeout=5.0)
    wire_log = _WireLog(wire)
    fuse = _CrashFuse(wire)
    client = CachedClient(fuse)
    elector = ShardLeaseElector(
        fuse, HA_SHARDS, identity=ident, lease_duration_s=HA_LEASE_S,
        renew_period_s=HA_RENEW_S, renew_deadline_s=HA_RENEW_DEADLINE_S,
        expected_replicas=len(HA_REPLICAS))
    own = elector.ownership
    fabric = _CountingFabric(pool)
    disp = FabricDispatcher(fabric, batch_window=0.005, poll_interval=0.05,
                            owns=own.owns_key)
    sched = ClusterScheduler(wire, native_sched=True)
    check(sched.engine.kernel_kind == "native",
          f"operator_fleet: {ident}'s scheduler runs"
          f" {sched.engine.kernel_kind}")
    slo = SloEngine(objectives=default_objectives(),
                    eval_period=FLEET_SLO_EVAL_S)
    plane = FleetPlane(fuse, ident, num_shards=HA_SHARDS, ownership=own,
                       publish_period=FLEET_PUBLISH_S,
                       stale_after_s=FLEET_STALE_S, slo_engine=slo)
    publish_t, aggregate_t = _Timed(plane, "publish"), _Timed(plane,
                                                              "aggregate")
    mgr = Manager(store=client, leader_elector=elector,
                  health_addr="127.0.0.1:0", dispatcher=disp,
                  decisions=sched.ledger, replica_id=ident,
                  slo_engine=slo, fleet=plane)
    slo.recorder = plane.slo.recorder = mgr.recorder
    mgr.add_controller(ComposabilityRequestReconciler(
        client, fabric, scheduler=sched, ownership=own,
        timing=RequestTiming(updating_poll=0.05, cleaning_poll=0.05)))
    res_rec = ComposableResourceReconciler(
        client, fabric, agent, decision_ledger=sched.ledger, dispatcher=disp,
        ownership=own,
        timing=ResourceTiming(attach_poll=0.05, visibility_poll=0.05))
    mgr.add_controller(res_rec)
    mgr.add_runnable(disp.run)
    mgr.add_runnable(plane.run)
    elector.on_acquire.append(lambda wins: reports.append(
        (ident, dict(wins), adopt_pending_ops(
            client, fabric, disp, shards=set(wins), num_shards=HA_SHARDS))))
    elector.on_ready.append(lambda shards: mgr.resync(
        lambda key, _s=frozenset(shards): shard_for(key, HA_SHARDS) in _s))
    elector.on_lose.append(lambda shard, reason: disp.abandon_unowned())
    return {"ident": ident, "wire": wire, "wire_log": wire_log,
            "fuse": fuse, "client": client, "elector": elector,
            "fabric": fabric, "dispatcher": disp, "sched": sched,
            "manager": mgr, "res_rec": res_rec, "slo": slo, "fleet": plane,
            "publish_t": publish_t, "aggregate_t": aggregate_t}


class _FleetWorld:
    """Stops the fleet phase's replicas, then its proxy and apiserver, and
    lets the lock-order witness go."""

    def __init__(self, replicas, proxy, server, frames, lockdep):
        self.replicas, self.proxy, self.server = replicas, proxy, server
        self.frames, self.lockdep = frames, lockdep
        self.stopped = False

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        for r in self.replicas:
            r["manager"].stop()
        for r in self.replicas:
            r["wire"].close()
        self.proxy.stop()
        self.server.stop()
        self.frames.stop()
        self.lockdep.disable()


def phase_operator_fleet(workdir: str, card: dict, gen: torch.Generator) -> dict:
    """The operator composes this card over the apiserver's wire, its
    fleet view, SLO engine and lock-order witness on (docstring, phase
    28). Returns the surviving replicas, still running;
    ``operator_fleet_busy`` stops them."""
    from tpu_composer_torch import GROUP, VERSION
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.analysis import lockdep
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposabilityRequestSpec, ComposableResource,
        ObjectMeta, ResourceDetails)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.runtime import metrics, wiremux
    from tpu_composer_torch.runtime.shards import ShardFencedError, shard_for
    from tpu_composer_torch.sim.apiserver import (
        FakeApiServer, core_node_doc, operator_resources)
    from tpu_composer_torch.sim.netchaos import BOTH, ChaosProxy

    root = os.path.join(workdir, "operator_fleet")
    agent = LocalNodeAgent(cdi_dir=os.path.join(root, "cdi"),
                           state_dir=os.path.join(root, "state"))
    agent.ensure_driver("localhost")
    gpus = agent.gpus()
    check(len(gpus) == 1, f"operator_fleet: the node agent lists {gpus}")
    witness = lockdep.enable(strict=True)
    check(witness.strict and not witness.reports,
          "operator_fleet: the lock-order witness is not fresh and strict")
    frames = _FrameCount(wiremux)
    frames.start()
    server = FakeApiServer(operator_resources(GROUP, VERSION))
    server.start("127.0.0.1", 0)
    # The one H100 under the chip resource, as kubelet would publish it.
    server.put_object("/api/v1/nodes",
                      core_node_doc("localhost", chips=len(gpus)))
    host, port = server.url.rsplit("//", 1)[1].split(":")
    proxy = ChaosProxy(host, int(port))
    pool = _recording_pool()
    replicas, reports = [], []
    world = _FleetWorld(replicas, proxy, server, frames, lockdep)
    reconnects0 = metrics.wire_mux_reconnects_total.total()
    degraded0 = metrics.wire_mux_degraded_total.total()
    try:
        for ident in HA_REPLICAS:
            url = proxy.url if ident == FLEET_PROXIED else server.url
            r = _fleet_replica(ident, url, pool, agent, reports)
            replicas.append(r)
            r["manager"].start(workers_per_controller=2)
        by_ident = {r["ident"]: r for r in replicas}
        owned = lambda r: set(r["elector"].owned_shards())  # noqa: E731
        check(_wait(lambda: sorted(len(owned(r)) for r in replicas)
                    == [2, 2, 2], 15.0),
              "operator_fleet: the shards never balanced:"
              f" {[sorted(owned(r)) for r in replicas]}")
        bootstrap = {r["ident"]: sorted(owned(r)) for r in replicas}

        def owner_of(key, among):
            shard = shard_for(key, HA_SHARDS)
            return next((r for r in among if shard in owned(r)), None)

        # The request's owner crashes; the proxied replica must survive it.
        name = next(n for n in (f"chip-smoke-fleet-{i}" for i in range(64))
                    if owner_of(n, replicas) is not by_ident[FLEET_PROXIED])
        slice_name = f"{name}-slice"
        victim = owner_of(name, replicas)
        survivors = [r for r in replicas if r is not victim]
        proxied = by_ident[FLEET_PROXIED]
        obs = survivors[0]["client"]

        def mid_attach():
            kids = victim["client"].list(
                ComposableResource, label_selector={LABEL_MANAGED_BY: name})
            return [k for k in kids if k.status.pending_op is not None
                    and k.status.state != "Online"]

        wire0 = {r["ident"]: len(r["wire_log"].calls) for r in replicas}
        t_submit = time.perf_counter()
        survivors[0]["client"].create(ComposabilityRequest(
            metadata=ObjectMeta(name=name),
            spec=ComposabilityRequestSpec(resource=ResourceDetails(
                type="gpu", model=H100_MODEL, size=1))))
        check(_wait(lambda: mid_attach(), 30.0, 0.0005),
              "operator_fleet: no child ever carried an attach intent")
        victim["fuse"].die()
        victim["dispatcher"].kill()
        t_crash = time.perf_counter()
        (caught,) = mid_attach() or [None]
        check(caught is not None, "operator_fleet: the child went Online"
              " before the crash")
        crash_state = {"child": caught.metadata.name,
                       "state": caught.status.state,
                       "pending_op": caught.status.pending_op.verb,
                       "request_owner": victim["ident"],
                       "submit_to_crash_ms": (t_crash - t_submit) * 1e3}
        emit("operator_fleet", check="crash", **crash_state)
        lost = sorted(owned(victim))

        def fleet_view(r):
            return _get_json(r["manager"].health_port, "/debug/fleet")

        def victim_stale(r):
            view = fleet_view(r)
            reps = view.get("replicas", {})
            live = [i for i, v in reps.items() if not v["stale"]]
            return (reps.get(victim["ident"], {}).get("stale") is True
                    and sorted(live) == sorted(s["ident"] for s in survivors))

        stale_bound = FLEET_STALE_S + 2 * FLEET_PUBLISH_S + 0.5
        check(_wait(lambda: all(_try(lambda r=r: victim_stale(r))
                                for r in survivors), stale_bound, 0.01),
              f"operator_fleet: the survivors' fleet views did not show"
              f" {victim['ident']} stale with 2 live replicas within"
              f" {stale_bound} s: {[fleet_view(r)['replicas'] for r in survivors]}")
        stale_ms = (time.perf_counter() - t_crash) * 1e3

        check(_wait(lambda: not owned(victim), HA_LEASE_S + 5.0),
              f"operator_fleet: the crashed replica never fenced {lost}")
        calls0 = len(victim["fabric"].calls)
        try:
            victim["res_rec"].reconcile(caught.metadata.name)
            fence = "returned"
        except ShardFencedError as e:
            fence = f"ShardFencedError: {e}"
        except Exception as e:  # noqa: BLE001 - named in the failure
            fence = f"{type(e).__name__}: {e}"
        hand_calls = len(victim["fabric"].calls) - calls0
        check(fence.startswith("ShardFencedError") and hand_calls == 0,
              f"operator_fleet: the crashed replica's reconcile gave {fence}"
              f" with {hand_calls} fabric calls")

        def running():
            req = obs.get(ComposabilityRequest, name)
            kids = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
            return (req.status.state == "Running" and len(kids) == 1
                    and kids[0].status.state == "Online")

        check(_wait(running, HA_LEASE_S + 30.0),
              "operator_fleet: the request never reached Running through a"
              " survivor over the wire")
        t_running = time.perf_counter()
        wire_running = {r["ident"]: r["wire_log"].by_verb(wire0[r["ident"]])
                        for r in replicas}
        req = obs.get(ComposabilityRequest, name)
        want_slice = dict(name=slice_name, topology="1x1", num_hosts=1,
                          chips_per_host=1, worker_hostnames=["localhost"])
        check(req.status.slice.to_dict() == want_slice,
              f"operator_fleet: status.slice {req.status.slice.to_dict()}"
              f" != {want_slice}")
        reserved = pool._slices.get(slice_name)
        check(sorted(pool._slices) == [slice_name]
              and reserved.nodes == ["localhost"]
              and reserved.model == H100_MODEL
              and reserved.topology == "1x1",
              f"operator_fleet: the pool holds {sorted(pool._slices)}, not"
              f" one reservation {slice_name} on localhost")
        (child,) = obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})
        check(child.spec.slice_name == slice_name
              and child.spec.chip_count == 1,
              f"operator_fleet: the child is not one GPU of {slice_name}:"
              f" {child.spec.to_dict()}")
        attaches = [ev for ev in pool.events if ev[0] == "attach"]
        check([ev[1] for ev in attaches] == [child.metadata.name]
              and not [ev for ev in pool.events if ev[0] == "release"],
              f"operator_fleet: the pool's attach log {pool.events} is not"
              " one attach of the child")
        group = f"{slice_name}-worker{child.spec.worker_id}"
        check(agent.check_visible("localhost", child.status.device_ids,
                                  group=group),
              "operator_fleet: the request's GPU does not enumerate")
        spec = _ha_spec(agent, slice_name, child, req, "operator_fleet")
        scans = {r["ident"]: r["sched"].engine.last_scan_kind
                 for r in replicas}

        # Process-token dedup: three replicas share this process's registry,
        # so the fleet merge counts its attach histogram once.
        registry = metrics.attach_to_ready_seconds.total_count()

        def merged_count(r):
            view = fleet_view(r)
            return view["merged"].get("tpuc_attach_to_ready_seconds",
                                      {}).get("count")

        check(_wait(lambda: all(merged_count(r) == registry
                                for r in survivors), 10.0, 0.01),
              f"operator_fleet: the fleet-merged attach count"
              f" {[merged_count(r) for r in survivors]} != the registry's"
              f" {registry}")
        views = {r["ident"]: fleet_view(r) for r in survivors}
        slo_docs = {r["ident"]: _get_json(r["manager"].health_port,
                                          "/debug/slo") for r in survivors}
        want_objectives = {"attach_p99", "completion_p50", "queue_wait_p99",
                           "repair_p99"}
        burn = {}
        for ident, doc in slo_docs.items():
            objs = doc["objectives"]
            check(set(objs) == want_objectives,
                  f"operator_fleet: {ident}'s /debug/slo lists {sorted(objs)}")
            for o, st in objs.items():
                check(math.isfinite(st["fast_burn"])
                      and math.isfinite(st["slow_burn"]),
                      f"operator_fleet: {ident}'s {o} burn rates {st}")
            burn[ident] = {o: [st["fast_burn"], st["slow_burn"]]
                           for o, st in sorted(objs.items())}
        fleet_burn = {ident: {o: [st["fast_burn"], st["slow_burn"]]
                              for o, st in v["slo"]["objectives"].items()}
                      for ident, v in views.items()}
        worker = _ha_worker_kernels(gen, "operator_fleet")

        # The proxied replica's wire goes dark for 1 s: live connections
        # reset, new ones accepted but silent until the heal.
        check(proxy.connections() >= 1,
              "operator_fleet: the proxied replica holds no connection")
        reconnects1 = metrics.wire_mux_reconnects_total.total()
        calls1 = len(proxied["wire_log"].calls)
        proxy.partition(BOTH)
        proxy.cut()
        t_drop = time.perf_counter()
        time.sleep(FLEET_DROP_S)
        proxy.heal()

        def back():
            fresh = proxied["wire"].get(ComposabilityRequest, name)
            seen = proxied["client"].get(ComposabilityRequest, name)
            watches = [c for c in proxied["wire_log"].calls[calls1:]
                       if c[2]]
            return (fresh.status.state == "Running"
                    and seen.status.state == "Running" and watches
                    and metrics.wire_mux_reconnects_total.total()
                    > reconnects1)

        check(_wait(lambda: _try(back), 30.0, 0.01),
              "operator_fleet: the proxied replica's KubeStore never came"
              " back after the drop")
        back_ms = (time.perf_counter() - t_drop) * 1e3
        after_drop = proxied["wire_log"].by_verb(calls1)
        prefixes = {rt.path_prefix for rt in proxied["wire"]._routes.values()}
        relists = sum(1 for m, p, stream in proxied["wire_log"].calls[calls1:]
                      if m == "GET" and not stream
                      and p.split("?")[0] in prefixes)
        check(owned(proxied), "operator_fleet: the proxied replica lost its"
              " shards in a 1 s drop")
        check(running(), "operator_fleet: the request left Running")

        degraded = metrics.wire_mux_degraded_total.total() - degraded0
        fell_back = [r["ident"] for r in replicas if r["wire"]._mux_failed]
        check(not degraded and not fell_back,
              f"operator_fleet: {fell_back} fell back to plain HTTP"
              f" ({degraded} demotions)")
        check(metrics.wire_mux_active.value() == 1.0,
              "operator_fleet: tpuc_wire_mux_active is not 1")
        lock_doc = _get_json(survivors[0]["manager"].health_port,
                             "/debug/lockdep")
        check(lock_doc["reports"] == [] and not witness.reports,
              f"operator_fleet: lock-order violations {lock_doc['reports']}")
    except BaseException:
        world.stop()
        raise
    wire_total = {}
    for r in replicas:
        for v, n in r["wire_log"].by_verb().items():
            wire_total[v] = wire_total.get(v, 0) + n
    rec = {"card": card["nvidia_smi"], "replicas": len(HA_REPLICAS),
           "shards": HA_SHARDS, "lease_duration_s": HA_LEASE_S,
           "renew_period_s": HA_RENEW_S, "publish_period_s": FLEET_PUBLISH_S,
           "stale_after_s": FLEET_STALE_S, "slo_eval_s": FLEET_SLO_EVAL_S,
           "slo_windows_s": [survivors[0]["slo"].fast_window,
                             survivors[0]["slo"].slow_window],
           "ping_period_s": FLEET_PING_S, "bootstrap": bootstrap,
           "proxied": FLEET_PROXIED, "request": name, "crash": crash_state,
           "lost": lost,
           "request_to_running_host_ms": (t_running - t_submit) * 1e3,
           "crash_to_running_ms": (t_running - t_crash) * 1e3,
           "crash_to_victim_stale_ms": stale_ms,
           "fence": fence, "fence_fabric_calls": hand_calls,
           "last_scan_kind": scans,
           "failover_adoptions": [
               (ident, sorted(wins.items()), rep.total)
               for ident, wins, rep in reports
               if ident != victim["ident"] and "failover" in wins.values()],
           "wire_requests_submit_to_running": wire_running,
           "wire_requests_by_verb": wire_total,
           "mux_frames": dict(frames.frames),
           "mux_reconnects": metrics.wire_mux_reconnects_total.total()
           - reconnects0,
           "drop": {"seconds": FLEET_DROP_S, "back_after_ms": back_ms,
                    "wire_after_drop": after_drop,
                    "relists": relists,
                    "watch_resumes": after_drop.get("WATCH resume", 0)},
           "attach_count": {"registry": registry,
                            "fleet_merged": merged_count(survivors[0]),
                            "live_replicas": len(survivors)},
           "fleet_publish": {r["ident"]: r["publish_t"].summary()
                             for r in replicas},
           "fleet_aggregate": {r["ident"]: r["aggregate_t"].summary()
                               for r in replicas},
           "slo_burn": burn, "fleet_slo_burn": fleet_burn,
           "lockdep": {"edges": len(lock_doc["edges"]),
                       "classes": len(lock_doc["classes"]),
                       "reports": len(lock_doc["reports"])},
           "pool_events": pool.events, "slice": slice_name,
           "cdi": child.status.cdi_device_id, **spec,
           "worker_kernels": worker}
    emit("operator_fleet", **{k: v for k, v in rec.items() if k != "env"},
         env=spec["env"])
    return {"manager": world, "survivors": survivors, "agent": agent,
            "group": group, "device_ids": list(child.status.device_ids),
            "witness": witness, **rec}


def phase_operator_fleet_busy(operator: dict) -> dict:
    """A second H100 request over the wire on the full host, held back;
    then the replicas, the proxy and the apiserver stop (docstring, phase
    29)."""
    from tpu_composer_torch.api import (
        ComposabilityRequest, ComposabilityRequestSpec, ComposableResource,
        ObjectMeta, ResourceDetails)
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY

    try:
        r = operator["survivors"][0]
        second = "chip-smoke-fleet-busy"
        port = r["manager"].health_port
        t0 = time.perf_counter()
        r["client"].create(ComposabilityRequest(
            metadata=ObjectMeta(name=second),
            spec=ComposabilityRequestSpec(resource=ResourceDetails(
                type="gpu", model=H100_MODEL, size=1))))

        def held_back():
            # The survivor that owns the request's shard holds its record;
            # the other answers 404.
            for s in operator["survivors"]:
                try:
                    doc = _get_json(s["manager"].health_port,
                                    f"/debug/scheduler/explain/{second}")
                except OSError:
                    continue
                latest = doc.get("latest", {})
                verdicts = {c["node"]: c["verdict"]
                            for c in latest.get("candidates", ())}
                if (latest.get("outcome") == "held-back"
                        and verdicts.get("localhost")
                        == "no-tpu-ports free=0 need=1"):
                    return latest
            return None

        check(_wait(lambda: _try(held_back), 30.0, 0.01),
              "operator_fleet_busy: the second request never got its"
              " no-tpu-ports hold-back record")
        held = held_back()
        held_ms = (time.perf_counter() - t0) * 1e3
        second_req = r["client"].get(ComposabilityRequest, second)
        check(second_req.status.state in ("", "NodeAllocating")
              and second_req.status.error,
              f"operator_fleet_busy: the second request's status"
              f" {second_req.status.to_dict()}")
        check(not r["client"].list(ComposableResource,
                                   label_selector={LABEL_MANAGED_BY: second}),
              "operator_fleet_busy: the second request got a child")
        lock_doc = _get_json(port, "/debug/lockdep")
        check(not lock_doc["reports"] and not operator["witness"].reports,
              f"operator_fleet_busy: lock-order violations"
              f" {lock_doc['reports']}")
    finally:
        operator["manager"].stop()
    out = {"second": {"error": second_req.status.error,
                      "outcome": held["outcome"],
                      "binding": held.get("binding")},
           "held_back_after_ms": held_ms,
           "lockdep_edges": len(lock_doc["edges"]),
           "card": operator["card"]}
    emit("operator_fleet_busy", **out)
    return out


BINARY_ATTACH_S = 1.0  # the fake fabric's attach takes this long: the crash window
BINARY_DRAIN_S = 30.0  # ProcFleet.drain's wait for a replica's exit
BINARY_POLL_SCALE = "0.05"  # reconciler re-polls 1 s -> 50 ms, as operator_fleet's
# The replicas' env: the REMOTE node agent, and operator_fleet's cuts
# (PERF.md section 4) through the binary's own variables.
BINARY_ENV = {"NODE_AGENT": "REMOTE", "TPUC_POLL_SCALE": BINARY_POLL_SCALE,
              "TPUC_FLEET_PUBLISH_PERIOD": str(FLEET_PUBLISH_S),
              "TPUC_FLEET_STALE_AFTER": str(FLEET_STALE_S),
              "TPUC_WIRE_PING_PERIOD": str(FLEET_PING_S),
              "TPUC_FABRIC_POLL_FALLBACK_MULT": "1"}

# The pod: a process started with the webhook's env and the plugin's
# Allocate env, as a container runtime would start the worker. It runs K1
# and K2 once each through ``_ha_worker_kernels`` and prints what it saw.
_POD_CHILD = r"""
import json, os, sys
import torch
import chip_smoke as cs
from tpu_composer_torch.ops import _build
cs.check(torch.cuda.is_available(), "pod: no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
cs._reset_counts()
bus = cs._card_bus()
kernels = cs._ha_worker_kernels(torch.Generator().manual_seed(int(sys.argv[1])),
                                "operator_binary")
torch.cuda.synchronize()
print("POD " + json.dumps({
    "bus": bus, "device": torch.cuda.get_device_name(0),
    "cuda_nodes": cs._cuda_nodes(), "launches": cs._counts(),
    "kernels": kernels, "built": sorted(_build.build_log),
    "env": {k: os.environ.get(k) for k in json.loads(sys.argv[2])}}),
    flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post_json(url: str, doc: dict, timeout: float = 10.0) -> tuple:
    """POST ``doc``; (status, parsed body, ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, body = resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read() or b"{}")
    return code, body, (time.perf_counter() - t0) * 1e3


def _run_cli(args: list, timeout: float = 60.0) -> subprocess.CompletedProcess:
    """``python -m tpu_composer_torch <args>``, as a user runs it."""
    env = dict(os.environ, PYTHONPATH=HERE)
    return subprocess.run([sys.executable, "-m", "tpu_composer_torch", *args],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _wire_by_verb(log, since: int = 0) -> dict:
    """The fake apiserver's request log by verb (a watch apart)."""
    out: dict = {}
    for method, path in list(log)[since:]:
        verb = "WATCH" if method == "GET" and "watch=" in path else method
        out[verb] = out.get(verb, 0) + 1
    return out


class _BinaryWorld:
    """Stops the binary phase's processes: the replicas and the servers
    (``ProcFleet.close``) and the node-agent daemon."""

    def __init__(self, fleet, agent_proc, agent_log):
        self.fleet, self.agent_proc, self.agent_log = fleet, agent_proc, agent_log
        self.obs = None  # the phase's own KubeStore reader
        self.stopped = False

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        try:
            for rep in self.fleet.live():
                os.kill(rep.proc.pid, 9)
                rep.proc.wait(timeout=10)
            self.fleet.close()
        finally:
            if self.agent_proc.poll() is None:
                self.agent_proc.kill()
                self.agent_proc.wait(timeout=10)
            self.agent_log.close()
            if self.obs is not None:
                self.obs.close()


def phase_operator_binary(workdir: str, card: dict, gen: torch.Generator,
                          seed: int) -> dict:
    """The H100 composed by the port's binary across processes (docstring,
    phase 30). Returns the running world; ``operator_binary_busy`` stops
    it."""
    import collections
    import urllib.request
    from types import SimpleNamespace

    from tpu_composer_torch import API_VERSION
    from tpu_composer_torch.admission import inject_pod_env, slice_env
    from tpu_composer_torch.admission.coordinates import (
        LABEL_INJECT, LABEL_WORKER_ID)
    from tpu_composer_torch.admission.server import MUTATE_PATH, VALIDATE_PATH
    from tpu_composer_torch.admission.validating import (
        AdmissionDenied, validate_request)
    from tpu_composer_torch.agent import native as agent_native
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent
    from tpu_composer_torch.api import ComposabilityRequest, ComposableResource
    from tpu_composer_torch.api.scheme import default_scheme
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.fleet.proc import ProcFleet
    from tpu_composer_torch.runtime.kubestore import (
        CHIP_RESOURCE, KubeConfig, KubeStore)
    from tpu_composer_torch.runtime.shards import shard_for
    from tpu_composer_torch.runtime.store import Store
    from tpu_composer_torch.sim.apiserver import core_node_doc

    root = os.path.join(workdir, "operator_binary")
    os.makedirs(root)
    # The node agent's native library, built by this process (phase 2)
    # before the daemon starts: the daemon loads this same file.
    lib_path = str(agent_native.build_native())
    compiled = agent_native.build_log.get("gpunode")
    native_build = {"compile_s": compiled[0] if compiled else None,
                    "library": os.path.relpath(lib_path, HERE)}
    emit("operator_binary", check="native_build", **native_build)
    gpus = LocalNodeAgent(cdi_dir=os.path.join(root, "probe-cdi"),
                          state_dir=os.path.join(root, "probe-state")).gpus()
    check(len(gpus) == 1, f"operator_binary: the node agent lists {gpus}")
    cuda_nodes = _cuda_nodes()

    # The node-agent daemon over the real /dev and /proc, with its kubelet
    # device plugin (which needs grpc).
    import importlib.util

    check(importlib.util.find_spec("grpc") is not None,
          "operator_binary: no grpc on this host for the device plugin")
    agent_dirs = {k: os.path.join(root, "agent", k)
                  for k in ("cdi", "state", "plugins")}
    agent_addr = f"127.0.0.1:{_free_port()}"
    argv = _agent_argv(agent_addr, agent_dirs)
    agent_log_path = os.path.join(root, "agent.log")
    agent_log = open(agent_log_path, "wb")
    t_agent = time.perf_counter()
    agent_proc = subprocess.Popen(
        argv, stdout=agent_log, stderr=subprocess.STDOUT, cwd=root,
        env=dict(os.environ, PYTHONPATH=HERE, NODE_NAME="localhost"))
    fleet = ProcFleet(
        os.path.join(root, "fleet"), nodes=0, shards=HA_SHARDS,
        expected_replicas=len(HA_REPLICAS), lease_duration_s=HA_LEASE_S,
        lease_renew_s=HA_RENEW_S, workers=2,
        pool_chips={H100_MODEL: len(gpus)},
        extra_env=dict(BINARY_ENV, NODE_AGENT_ENDPOINT_TEMPLATE=agent_addr),
        extra_flags=["--webhook-bind-address", "127.0.0.1:0"])
    world = _BinaryWorld(fleet, agent_proc, agent_log)
    try:
        def agent_up():
            try:
                with urllib.request.urlopen(f"http://{agent_addr}/healthz",
                                            timeout=1) as resp:
                    return resp.status == 200
            except OSError:
                check(agent_proc.poll() is None,
                      f"operator_binary: the node agent exited"
                      f" {agent_proc.returncode}: {_tail(agent_log_path)}")
                return False

        check(_wait(agent_up, 60.0, 0.02),
              "operator_binary: the node agent never answered /healthz")
        agent_ready_s = time.perf_counter() - t_agent
        logged = _tail(agent_log_path)
        check(f"(native library {lib_path})" in logged,
              f"operator_binary: the node agent did not load {lib_path}:"
              f" {logged}")
        with open(f"/proc/{agent_proc.pid}/maps") as f:
            mapped = lib_path in f.read()
        check(mapped, f"operator_binary: {lib_path} is not mapped in the"
              " node agent")

        # The fake fabric's attach takes BINARY_ATTACH_S on the pool's own
        # timer (ProcFleet builds the pool; the phase sets its delay).
        fleet.pool._async_delay = BINARY_ATTACH_S
        fleet.apiserver.put_object("/api/v1/nodes", core_node_doc(
            "localhost", chips=len(gpus), chip_resource=CHIP_RESOURCE))
        t_spawn, spawn_s = {}, {}
        for ident in HA_REPLICAS:
            t_spawn[ident] = time.perf_counter()
            fleet.spawn(ident, wait_ready_s=0)
        for ident in HA_REPLICAS:
            port_file = fleet.replicas[ident].artifacts["port"]
            check(_wait(lambda: os.path.exists(port_file)
                        or not fleet.replicas[ident].alive(), 60.0, 0.01),
                  f"operator_binary: {ident} wrote no port file")
            spawn_s[ident] = time.perf_counter() - t_spawn[ident]
            fleet.wait_ready(ident, timeout=60.0)

        def spread():
            return sorted(collections.Counter(
                fleet.shard_owners().values()).values())

        check(_wait(lambda: spread() == [2, 2, 2]
                    and len(fleet.shard_owners()) == HA_SHARDS, 30.0, 0.01),
              f"operator_binary: the shards never balanced:"
              f" {fleet.shard_owners()}")
        bootstrap = dict(sorted(fleet.shard_owners().items()))
        webhooks = {}
        for ident in HA_REPLICAS:
            line = [ln for ln in fleet.tail_log(ident, 400).splitlines()
                    if "admission webhooks serving on" in ln]
            check(line, f"operator_binary: {ident} serves no webhook")
            webhooks[ident] = line[-1].split("serving on ")[1].split()[0]

        url = fleet.apiserver.url
        obs = world.obs = KubeStore(KubeConfig(host=url), cache_reads=False,
                                    wire_mux=False)
        name = "chip-smoke-binary"
        slice_name = f"{name}-slice"

        def kids():
            return obs.list(ComposableResource,
                            label_selector={LABEL_MANAGED_BY: name})

        def kid_docs():
            # Read in this process, off the wire: the wire counts below
            # are the operator's own.
            with fleet.apiserver.state.lock:
                return [json.loads(json.dumps(o)) for (p, _), o
                        in fleet.apiserver.state.objects.items()
                        if p == fleet.res_prefix
                        and (o["metadata"].get("labels") or {}).get(
                            LABEL_MANAGED_BY) == name]

        def cr_state(cr):
            with fleet.apiserver.state.lock:
                doc = fleet.apiserver.state.objects.get((fleet.cr_prefix, cr))
                return ((doc or {}).get("status") or {}).get("state")

        log0 = len(fleet.apiserver.request_log)
        code, _, submit_ms = _post_json(url + fleet.cr_prefix, {
            "apiVersion": API_VERSION,
            "kind": "ComposabilityRequest", "metadata": {"name": name},
            "spec": {"resource": {"type": "gpu", "model": H100_MODEL,
                                  "size": 1}}})
        t_submit = time.perf_counter()
        check(code == 201, f"operator_binary: the apiserver answered {code}")

        def mid_attach():
            return [k for k in kid_docs()
                    if (k.get("status") or {}).get("pending_op")
                    and k["status"].get("state") != "Online"]

        check(_wait(lambda: mid_attach(), 30.0, 0.001),
              "operator_binary: no child ever carried an attach intent")
        # The victim: the replica whose shard holds the child, which wrote
        # its attach intent and waits on the fabric. The request's placer
        # keeps the placement's decision ring; where the victim is also
        # the placer, its ring is read before the kill (it dies with it).
        owners0 = fleet.shard_owners()
        victim = owners0.get(shard_for(mid_attach()[0]["metadata"]["name"],
                                       HA_SHARDS))
        placer = owners0.get(shard_for(name, HA_SHARDS))
        check(victim is not None and placer is not None,
              f"operator_binary: unowned shards {owners0}")
        ring_file = None
        if placer == victim:
            ring_file = os.path.join(root, "decisions.json")
            ring = fleet.debug(victim, f"/debug/scheduler/explain/{name}")
            with open(ring_file, "w") as f:
                json.dump({"requests": {name: ring["decisions"]}}, f)
        fleet.kill(victim)
        t_kill = time.perf_counter()
        (caught,) = mid_attach() or [None]
        check(caught is not None,
              "operator_binary: the child went Online before the kill")
        check("trace_prekill" in fleet.replicas[victim].artifacts,
              f"operator_binary: no pre-kill trace snapshot of {victim}")
        crash = {"victim": victim, "placer": placer,
                 "child": caught["metadata"]["name"],
                 "state": caught["status"].get("state"),
                 "pending_op": caught["status"]["pending_op"]["verb"],
                 "submit_to_kill_ms": (t_kill - t_submit) * 1e3}
        emit("operator_binary", check="kill", **crash)
        survivors = [i for i in HA_REPLICAS if i != victim]

        def running():
            ks = kid_docs()
            return (cr_state(name) == "Running" and len(ks) == 1
                    and ks[0]["status"].get("state") == "Online")

        check(_wait(running, HA_LEASE_S + 30.0, 0.005),
              "operator_binary: the request never reached Running through a"
              " survivor")
        t_running = time.perf_counter()
        wire = _wire_by_verb(fleet.apiserver.request_log, log0)
        owners = fleet.shard_owners()
        check(len(owners) == HA_SHARDS and victim not in owners.values(),
              f"operator_binary: the shards after the kill {owners}")
        req = obs.get(ComposabilityRequest, name)
        (child,) = kids()
        want_slice = dict(name=slice_name, topology="1x1", num_hosts=1,
                          chips_per_host=1, worker_hostnames=["localhost"])
        check(req.status.slice.to_dict() == want_slice,
              f"operator_binary: status.slice {req.status.slice.to_dict()}")
        raw, _ = fleet.pool.poll_events(0, timeout=0)
        fabric_ops = [(e.verb, e.resource, e.outcome) for e in raw
                      if e.type == "op_completed"
                      and e.verb in ("add", "remove")]
        check(fabric_ops == [("add", child.metadata.name, "ok")],
              f"operator_binary: the pool's event log {fabric_ops} is not"
              " one attach of the child")
        # The spec the daemon wrote: slice_env exactly, CUDA's card.
        spec = _ha_spec(SimpleNamespace(cdi_dir=agent_dirs["cdi"]),
                        slice_name, child, req, "operator_binary")
        group = f"{slice_name}-worker{child.spec.worker_id}"

        # The webhook of a live replica: the pod's patch is inject_pod_env.
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "chip-smoke-pod", "labels": {
                   LABEL_INJECT: name, LABEL_WORKER_ID: "0"}},
               "spec": {"containers": [{"name": "worker", "image": "torch"}]}}
        hook = webhooks[survivors[0]]
        code, review, mutate_ms = _post_json(
            f"http://{hook}{MUTATE_PATH}",
            {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
             "request": {"uid": "pod-1", "object": pod}})
        import base64

        (op,) = json.loads(base64.b64decode(review["response"]["patch"]))
        want_pod = inject_pod_env(json.loads(json.dumps(pod)),
                                  req.status.slice, 0, H100_MODEL)
        check(code == 200 and review["response"]["allowed"]
              and op["path"] == "/spec" and op["value"] == want_pod["spec"],
              f"operator_binary: the webhook's patch {op} is not"
              f" inject_pod_env's {want_pod['spec']}")
        pod_env = {e["name"]: e["value"]
                   for e in op["value"]["containers"][0]["env"]}
        check(pod_env == slice_env(req.status.slice, 0, H100_MODEL),
              f"operator_binary: the pod env {pod_env}")
        bad = {"apiVersion": API_VERSION,
               "kind": "ComposabilityRequest", "metadata": {"name": "bad"},
               "spec": {"resource": {"type": "gpu", "model": H100_MODEL,
                                     "size": 1,
                                     "allocation_policy": "differentnode",
                                     "target_node": "worker-0"}}}
        code, denied, validate_ms = _post_json(
            f"http://{hook}{VALIDATE_PATH}",
            {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
             "request": {"uid": "bad-1", "object": bad}})
        try:
            validate_request(Store(), default_scheme().decode(bad))
            want_msg = None
        except AdmissionDenied as e:
            want_msg = str(e)
        check(want_msg and denied["response"]["allowed"] is False
              and denied["response"]["status"]["message"] == want_msg,
              f"operator_binary: the invalid request's review {denied}"
              f" (validate_request says {want_msg!r})")

        # The device plugin: ListAndWatch lists the card, Allocate names it
        # as the pod, which holds only its node, sees it: CUDA's device 0.
        from tpu_composer_torch.agent.cdi import NVIDIA_CONTROL_NODES

        plugin = _plugin_allocate(agent_dirs["plugins"], group)
        check(plugin["listed"] == [[f"{group}/0", "Healthy"]],
              f"operator_binary: ListAndWatch lists {plugin['listed']}")
        check(plugin["devices"] == [cuda_nodes[0], *NVIDIA_CONTROL_NODES]
              and plugin["cdi"] == [f"tpu.composer.dev/gpu={group}"]
              and plugin["envs"] == {"CUDA_VISIBLE_DEVICES": "0",
                                     "CUDA_DEVICE_ORDER": "PCI_BUS_ID"},
              f"operator_binary: Allocate answered {plugin}")

        # The pod process on the card, with the webhook's and Allocate's env.
        pod_proc = subprocess.run(
            [sys.executable, "-c", _POD_CHILD, str(seed),
             json.dumps(sorted(pod_env) + sorted(plugin["envs"]))],
            cwd=HERE, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=HERE, **pod_env,
                     **plugin["envs"]))
        lines = [ln for ln in pod_proc.stdout.splitlines()
                 if ln.startswith("POD ")]
        check(pod_proc.returncode == 0 and lines,
              f"operator_binary: the pod exited {pod_proc.returncode}:"
              f" {pod_proc.stderr[-3000:]}")
        pod_out = json.loads(lines[-1][4:])
        card_bus = _card_bus()
        check(pod_out["bus"] == card_bus
              and pod_out["cuda_nodes"] == cuda_nodes,
              f"operator_binary: the pod ran on {pod_out['bus']}"
              f" {pod_out['cuda_nodes']}, not the composed card {card_bus}"
              f" {cuda_nodes}")
        check(not pod_out["built"],
              f"operator_binary: the pod compiled {pod_out['built']}")
        check(pod_out["env"] == {**pod_env, **plugin["envs"]},
              f"operator_binary: the pod's env {pod_out['env']}")
        want_launches = {k: int(k in ("flash_fwd", "paged_decode"))
                         for k in _counts()}
        check(pod_out["launches"] == want_launches,
              f"operator_binary: the pod launched {pod_out['launches']},"
              f" not K1 and K2 once each ({want_launches})")

        # explain, through the binary: the placer's live ring, or the ring
        # read from it before the kill.
        if ring_file is None:
            res = _run_cli(["explain", name, "--addr", "127.0.0.1:"
                            f"{fleet.replicas[placer].health_port}"])
        else:
            res = _run_cli(["explain", name, "--file", ring_file])
        check(res.returncode == 0 and "localhost" in res.stdout,
              f"operator_binary: explain exited {res.returncode}:"
              f" {res.stdout[-2000:]} {res.stderr[-2000:]}")
    except BaseException:
        world.stop()
        raise
    rec = {"card": card["nvidia_smi"], "replicas": len(HA_REPLICAS),
           "shards": HA_SHARDS, "lease_duration_s": HA_LEASE_S,
           "renew_period_s": HA_RENEW_S, "env": BINARY_ENV,
           "attach_s": BINARY_ATTACH_S, "native_build": native_build,
           "agent_ready_s": agent_ready_s, "spawn_to_port_file_s": spawn_s,
           "bootstrap": bootstrap, "request": name, "crash": crash,
           "submit_post_ms": submit_ms,
           "kill_to_running_ms": (t_running - t_kill) * 1e3,
           "submit_to_running_ms": (t_running - t_submit) * 1e3,
           "wire_requests_by_verb": wire, "fabric_ops": fabric_ops,
           "spec": {k: v for k, v in spec.items() if k != "env"},
           "webhook_mutate_ms": mutate_ms, "webhook_validate_ms": validate_ms,
           "denial": want_msg, "plugin": plugin,
           "pod": {k: v for k, v in pod_out.items() if k != "env"},
           "explain": "file" if ring_file else f"addr of {placer}",
           "explain_lines": res.stdout.count("\n")}
    emit("operator_binary", **rec)
    return {"world": world, "fleet": fleet, "survivors": survivors,
            "victim": victim, "agent_addr": agent_addr, "group": group,
            "device_ids": list(child.status.device_ids), "obs": obs,
            "launches": pod_out["launches"], **rec}


def _explain(fleet, name: str) -> subprocess.CompletedProcess:
    """``python -m tpu_composer_torch explain <name>`` against the replica
    that owns the request's shard, whose scheduler records each retry of
    a held-back request."""
    from tpu_composer_torch.runtime.shards import shard_for

    owner = fleet.shard_owners().get(shard_for(name, HA_SHARDS))
    port = fleet.replicas[owner].health_port if owner else 0
    return _run_cli(["explain", name, "--addr", f"127.0.0.1:{port}"])


def _agent_argv(addr: str, dirs: dict) -> list:
    """The node-agent daemon over this host's real /dev and /proc, with
    its kubelet device plugin."""
    return [sys.executable, "-m", "tpu_composer_torch.agent.serve",
            "--bind", addr, "--dev-dir", "/dev", "--proc-dir", "/proc",
            "--cdi-dir", dirs["cdi"], "--state-dir", dirs["state"],
            "--device-plugin-dir", dirs["plugins"]]


def _card_bus() -> str:
    """The PCI bus id of this process's CUDA device 0, as CUDA reports it."""
    props = torch.cuda.get_device_properties(0)
    return (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
            f"{props.pci_device_id:02x}.0")


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")[-n:]


def _plugin_allocate(plugin_dir: str, group: str) -> dict:
    """The kubelet's side of the device plugin over its unix socket: the
    first ListAndWatch answer, then Allocate of the group's device."""
    import grpc

    from tpu_composer_torch.agent import deviceplugin_pb2 as pb
    from tpu_composer_torch.agent.plugin import API_VERSION, PLUGIN_SOCKET

    sock = os.path.join(plugin_dir, PLUGIN_SOCKET)
    check(_wait(lambda: os.path.exists(sock), 30.0, 0.01),
          f"operator_binary: no plugin socket at {sock}")
    with grpc.insecure_channel(f"unix:{sock}") as channel:
        watch = channel.unary_stream(
            f"/{API_VERSION}.DevicePlugin/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        stream = watch(pb.Empty(), timeout=30.0)
        first = next(stream)
        stream.cancel()
        listed = [[d.ID, d.health] for d in first.devices]
        allocate = channel.unary_unary(
            f"/{API_VERSION}.DevicePlugin/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)
        t0 = time.perf_counter()
        resp = allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devices_ids=[f"{group}/0"])]),
            timeout=10.0)
        allocate_ms = (time.perf_counter() - t0) * 1e3
    (c,) = resp.container_responses
    return {"listed": listed, "allocate_ms": allocate_ms,
            "envs": dict(c.envs), "devices": [d.host_path for d in c.devices],
            "cdi": [d.name for d in c.cdi_devices]}


def phase_operator_binary_busy(operator: dict) -> dict:
    """A second H100 request held back, the busy guard across processes,
    then every replica drained and the agent stopped; the traces merged
    (docstring, phase 31)."""
    import threading as _threading

    from tpu_composer_torch import API_VERSION
    from tpu_composer_torch.agent.nodeagent import DeviceBusyError
    from tpu_composer_torch.agent.remote import RemoteNodeAgent
    from tpu_composer_torch.api import ComposableResource
    from tpu_composer_torch.api.types import LABEL_MANAGED_BY
    from tpu_composer_torch.runtime import tracing
    from tpu_composer_torch.runtime.shards import shard_for

    world, fleet = operator["world"], operator["fleet"]
    try:
        second = "chip-smoke-binary-busy"
        url = fleet.apiserver.url
        t0 = time.perf_counter()
        code, _, _ = _post_json(url + fleet.cr_prefix, {
            "apiVersion": API_VERSION,
            "kind": "ComposabilityRequest", "metadata": {"name": second},
            "spec": {"resource": {"type": "gpu", "model": H100_MODEL,
                                  "size": 1}}})
        check(code == 201, f"operator_binary_busy: the apiserver answered {code}")
        def held_back():
            res = _explain(fleet, second)
            return (res if res.returncode == 0 and "held-back" in res.stdout
                    and "localhost: no-tpu-ports free=0 need=1" in res.stdout
                    else None)

        check(_wait(held_back, 30.0, 0.2),
              "operator_binary_busy: explain never showed the second"
              " request's no-tpu-ports hold-back")
        held_ms = (time.perf_counter() - t0) * 1e3
        explained = held_back().stdout
        check(not operator["obs"].list(ComposableResource, label_selector={
            LABEL_MANAGED_BY: second}),
            "operator_binary_busy: the second request got a child")
        # The drain guard, answered by the daemon from its /proc scan.
        remote = RemoteNodeAgent(lambda node: operator["agent_addr"])
        try:
            remote.drain("localhost", operator["device_ids"],
                         group=operator["group"])
            busy = "drained"
        except DeviceBusyError as e:
            busy = str(e)
        check(f"{os.getpid()}(" in busy,
              f"operator_binary_busy: the drain gave {busy!r}, not this"
              f" process {os.getpid()} holding the card")

        # Drain every survivor at once; then the agent.
        exits, stop_s = {}, {}

        def drain(ident):
            t = time.perf_counter()
            rep = fleet.drain(ident, timeout=BINARY_DRAIN_S)
            exits[ident] = rep.proc.returncode
            stop_s[ident] = time.perf_counter() - t

        threads = [_threading.Thread(target=drain, args=(i,))
                   for i in operator["survivors"]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(all(rc == 0 for rc in exits.values())
              and len(exits) == len(operator["survivors"]),
              f"operator_binary_busy: the replicas exited {exits}")
        released = fleet.shard_owners()
        check(released == {},
              f"operator_binary_busy: shard leases still held {released}")
        agent_proc = world.agent_proc
        t = time.perf_counter()
        agent_proc.terminate()
        agent_rc = agent_proc.wait(timeout=BINARY_DRAIN_S)
        agent_stop_s = time.perf_counter() - t
        check(agent_rc == 0, f"operator_binary_busy: the agent exited"
              f" {agent_rc}")

        # trace-merge over the survivors' files and the victim's snapshot.
        files = fleet.trace_files()
        merged_path = os.path.join(fleet.workdir, "merged.json")
        res = _run_cli(["trace-merge", "--out", merged_path, *files])
        check(res.returncode == 0, f"operator_binary_busy: trace-merge"
              f" exited {res.returncode}: {res.stderr[-2000:]}")
        with open(merged_path) as f:
            merged = json.load(f)
        names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
                 if e.get("name") == "process_name"}
        pids = {tracing.replica_pid(i): i for i in HA_REPLICAS}
        check(all(names.get(p) == i for p, i in pids.items()),
              f"operator_binary_busy: the merged trace names {names}")
        victim_pid = tracing.replica_pid(operator["victim"])
        spans: dict = {}
        for e in merged["traceEvents"]:
            tid = (e.get("args") or {}).get("trace_id")
            if e.get("ph") == "X" and tid:
                spans.setdefault(tid, []).append(e)
        stitched = {f["args"]["trace_id"] for f in merged["traceEvents"]
                    if f.get("ph") in ("s", "f")
                    and f["args"].get("stitched")}
        flows = [t for t, evs in spans.items() if t in stitched
                 and victim_pid in {e["pid"] for e in evs}
                 and any(e["name"] == "adopt" and e["pid"] != victim_pid
                         for e in evs)]
        check(flows, "operator_binary_busy: no flow from the victim's intent"
              " to a survivor's adoption in the merged trace")
    finally:
        world.stop()
    out = {"second": second, "held_back_after_ms": held_ms,
           "explain": [ln for ln in explained.splitlines()
                       if "no-tpu-ports" in ln or "held-back" in ln][:3],
           "busy": busy, "replica_exits": exits, "replica_stop_s": stop_s,
           "agent_exit": agent_rc, "agent_stop_s": agent_stop_s,
           "trace_files": len(files),
           "merged_events": len(merged["traceEvents"]),
           "stitched_flows": merged.get("metadata", {}).get("stitched_flows"),
           "failover_flows": len(flows), "card": operator["card"]}
    emit("operator_binary_busy", **out)
    return out


def phase_composed_worker(gen: torch.Generator, operator: dict) -> dict:
    """The composed H100 worker: the kernels at the probe's new shapes in
    this process (uncounted), then the worker's side of the operator's
    composition (the env read back from the CDI spec of the child that
    the operator composed through the REST_CM backend, the coordinates,
    the bootstrap) and the staged probe run on the card with that env.
    Returns the records and the probe child's launch counts."""
    from tpu_composer_torch.workload import SliceCoords, bootstrap_distributed
    from tpu_composer_torch.workload.probe import staged_accelerator_probe

    kernels = _composed_kernels(gen)
    env = operator["env"]
    coords = SliceCoords.from_env(env)
    want = (0, 1, 1, ["localhost"], "1x1", operator["slice"], H100_MODEL)
    got = (coords.worker_id, coords.num_workers, coords.num_chips,
           coords.worker_hostnames, coords.topology, coords.slice_name,
           coords.model)
    check(got == want, f"coordinates {got} != {want}")
    check(bootstrap_distributed(coords) == coords,
          "bootstrap changed the coordinates")
    emit("composed_worker", check="composed", topology=coords.topology,
         cdi=operator["cdi"], device_nodes=operator["device_nodes"], env=env,
         coordinator=coords.coordinator_address)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = staged_accelerator_probe(repo_root=HERE, env=env,
                                   timeouts=PROBE_TIMEOUTS_S)
    probe_s = time.perf_counter() - t0
    stages = res["stages"]
    emit("composed_worker", check="probe", seconds=probe_s, **res)
    check("failed_stage" not in res,
          f"probe stage {res.get('failed_stage')} failed:"
          f" {res.get('diagnosis')}")
    check(res["completed"] == ["devnodes", "backend_init", "matmul",
                               "flash_attn", "qualify", "qualify_large",
                               "decode"],
          f"probe completed only {res['completed']}")
    for name, rec in stages.items():
        bad = sorted(k for k in rec if "error" in k or k == "skipped")
        bad += [f"configs[{i}].error" for i, c in
                enumerate(rec.get("configs", ())) if "error" in c]
        check(not bad, f"probe stage {name}: {bad}: {rec}")
        check(not rec.get("built"),
              f"probe stage {name} rebuilt kernels {rec.get('built')}")
    check(stages["flash_attn"].get("numerics_ok") is True,
          f"probe flash numerics: {stages['flash_attn']}")
    check(stages["backend_init"]["backend"] == "cuda",
          f"probe backend {stages['backend_init']}")
    launches = dict.fromkeys(_counts(), 0)
    for rec in stages.values():
        for k, n in rec.get("launches", {}).items():
            launches[k] += n
    large, dec = stages["qualify_large"], stages["decode"]
    out = {"kernels": kernels, "probe_s": probe_s, "launches": launches,
           "qualify_large_mfu": large.get("mfu"),
           "qualify_large_tokens_per_s": large["tokens_per_s"],
           "qualify_mfu": stages["qualify"].get("mfu"),
           "decode_tokens_per_s": {k: v for k, v in dec.items()
                                   if k.endswith("tokens_per_s")},
           "flash_long": {k: stages["flash_attn"].get(k) for k in
                          ("fwd_speedup_long", "bwd_speedup_long")}}
    emit("composed_worker", check="summary",
         **{k: v for k, v in out.items() if k != "kernels"})
    return out


def phase_operator_busy(operator: dict, phase: str = "operator_busy") -> dict:
    """The busy guard on the composed group (docstring, phases 20, 24
    and 25); then that operator stops."""
    from tpu_composer_torch.agent.nodeagent import DeviceBusyError

    agent, group, ids = operator["agent"], operator["group"], operator["device_ids"]
    try:
        idle = agent.check_no_loads("localhost", ids, group=group)
        check(not idle, "check_no_loads reports the composed card idle")
        try:
            agent.drain("localhost", ids, force=False, group=group)
        except DeviceBusyError as e:
            busy = str(e)
        else:
            raise RuntimeError("drain(force=False) did not raise DeviceBusyError")
        check(f" {os.getpid()}(" in f" {busy}",
              f"DeviceBusyError does not name this process {os.getpid()}: {busy}")
    finally:
        operator["manager"].stop()
    out = {"check_no_loads": idle, "device_busy": busy, "pid": os.getpid(),
           "group": group}
    emit(phase, **out)
    return out


# The stages of the NCCL world of 4 (``--nccl-world``): the pipelined
# meshes, and a bf16 run at pp = 4 (one layer a stage); then the reshards.
NCCL_WORLD_4 = (
    PIPE_WORLD_4 + (("run_pp4_m4", "run",
                     dict(axes={"pp": 4}, pipeline_microbatches=4)),),
    RESHARD_WORLD_4,
)


def _composed_rank(env: dict, local_rank: int, results) -> None:
    """One process of a composed host: joins the slice from the
    coordinate env alone (``bootstrap_distributed``, NCCL) and runs
    ``qualify_slice`` across the world; sends the parent its results and
    launch counts (or its traceback). It prints nothing to stdout."""
    import traceback

    import torch.distributed as dist

    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        sys.path.insert(0, HERE)
        torch.backends.cuda.matmul.allow_tf32 = False
        from tpu_composer_torch.workload import (
            bootstrap_distributed,
            qualify_slice,
        )

        coords = bootstrap_distributed(env=env, local_rank=local_rank,
                                       timeout_s=MESH_GROUP_TIMEOUT_S)
        res = qualify_slice()
        res.update(rank=dist.get_rank(), world=dist.get_world_size(),
                   local_rank=local_rank, worker=coords.worker_id,
                   device=torch.cuda.current_device(), launches=_counts())
        results.put((local_rank, None, res))
    except BaseException:
        results.put((local_rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_composed_slice(n_gpus: int) -> dict:
    """A composed slice of one H100 host of ``n_gpus``: its coordinate
    env from ``slice_env``, one spawned process per GPU joining the
    world over NCCL from that env alone, ``qualify_slice`` across it. The
    allreduce bus bandwidth is NCCL's over the host's NVLink."""
    import multiprocessing as mp
    import queue
    import socket

    from tpu_composer_torch.admission import slice_env
    from tpu_composer_torch.api.types import SliceStatus
    from tpu_composer_torch.topology import solve_slice

    shape = solve_slice(H100_MODEL, n_gpus)
    status = SliceStatus(name="composed", topology=shape.topology,
                         num_hosts=1, chips_per_host=shape.chips_per_host,
                         worker_hostnames=["localhost"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = slice_env(status, 0, H100_MODEL, master_port=port)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_composed_rank, args=(env, r, results))
             for r in range(n_gpus)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + MESH_DEADLINE_S
        while len(got) < n_gpus:
            check(time.monotonic() < deadline,
                  f"composed slice: {n_gpus - len(got)} processes did not"
                  f" report within {MESH_DEADLINE_S} s")
            try:
                lr, err, res = results.get(timeout=2)
            except queue.Empty:
                continue
            check(err is None, f"composed slice: local rank {lr} failed:"
                               f"\n{err}")
            got[lr] = res
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == n_gpus else 0)
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks = [got[r] for r in range(n_gpus)]
    check(sorted(r["rank"] for r in ranks) == list(range(n_gpus))
          and all(r["world"] == n_gpus for r in ranks),
          f"composed slice ranks {[(r['rank'], r['world']) for r in ranks]}")
    check(len({r["device"] for r in ranks}) == n_gpus,
          "composed slice: two processes on one card")
    check(all(r["transport"] == "nccl" and r["allreduce_gbps"] > 0
              and np.isfinite(r["train_loss"]) for r in ranks),
          f"composed slice qualify: {ranks}")
    out = {"wall_s": time.perf_counter() - t0, "topology": shape.topology,
           "env": env, "ranks": ranks}
    emit("composed_slice", **out)
    return out


def main_nccl_world(seed: int) -> int:
    """The pipeline and reshard stages over NCCL, one rank a card, on 4
    cards: the tasks of ``NCCL_WORLD_4`` checked as on one card, against
    ``train_exact``'s one-process step on card 0."""
    card = phase_card()
    check(card["count"] >= 4, f"--nccl-world needs 4 cards, has"
                              f" {card['count']}")
    phase_build()
    exact = phase_train_exact(seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    world = None
    try:
        t0 = time.perf_counter()
        world = _World(4, NCCL_WORLD_4, _write_ref(seed, exact, workdir),
                       workdir, backend="nccl")
        counts = {}
        for stage, tasks in enumerate(NCCL_WORLD_4):
            ranks = world.join(stage)
            _stage_records("nccl_world", 4, tasks, ranks, exact)
            counts[stage] = _world_counts({4: ranks})
            _world_check(counts[stage], "nccl_world")
        emit("nccl_world", wall_s=time.perf_counter() - t0,
             launches=counts)
        phase_composed_slice(4)
    finally:
        if world is not None:
            world.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--nccl-world", action="store_true",
        help="instead of the one-card run: the pipeline and reshard"
             " stages over NCCL in a world of 4 ranks, one card each")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpu_composer_torch")):
        print("chip_smoke: tpu_composer_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # fp32 reference matmuls in full fp32, on both library paths.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.nccl_world:
        return main_nccl_world(args.seed)

    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    seconds = {}

    def timed_phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed_phase("card", phase_card)
    timed_phase("build", phase_build)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_devtools_") as d:
        timed_phase("devtools", phase_devtools, d)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_image_") as d:
        timed_phase("operator_image", phase_operator_image, d, card)
    flash = timed_phase("flash_fwd", phase_flash, gen)
    paged = timed_phase("paged_decode", phase_paged, gen)
    bwd = timed_phase("flash_bwd", phase_flash_bwd, gen)

    # Each main path: every count is set to 0 just before its phases run
    # and read just after; each of the path's kernels must have launched.
    # The multi-rank paths' kernels run in their spawned ranks, which set
    # their counts to 0 before each path's stage and report them after;
    # the composed worker's in the probe's child, which reports each
    # stage's launches.
    done, paths = {}, {}
    seed = args.seed
    train_kernels = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    worlds: dict = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name, kernels, phases in (
                ("serving", ("flash_fwd", "paged_decode",
                             "paged_decode_int8"),
                 (("serve_exact", lambda: phase_serve_exact(rng, seed)),
                  ("serve", lambda: phase_serve(rng, seed)))),
                ("moe_serving", ("paged_decode", "paged_decode_int8"),
                 (("moe_serve_exact",
                   lambda: phase_moe_serve_exact(rng, seed)),
                  ("moe_serve", lambda: phase_moe_serve(rng, seed)))),
                ("speculative", ("flash_fwd",),
                 (("speculative", lambda: phase_speculative(rng, seed)),)),
                ("training", train_kernels,
                 (("train_exact", lambda: phase_train_exact(seed)),
                  ("train", lambda: phase_train(seed)),
                  ("qualify", phase_qualify))),
                ("moe_training", train_kernels,
                 (("train_moe", lambda: phase_train_moe(seed)),)),
                ("mesh_training", train_kernels,
                 (("mesh_train", lambda: phase_mesh_train(
                     seed, done["train_exact"], done["train_moe"], workdir,
                     worlds)),
                  ("mesh_nccl", lambda: phase_mesh_nccl(seed)))),
                ("pipeline_training", train_kernels,
                 (("pipeline_train", lambda: phase_pipeline_train(
                     gen, done["train_exact"], worlds)),)),
                ("reshard_training", train_kernels,
                 (("reshard_train", lambda: phase_reshard_train(
                     done["train_exact"], worlds)),)),
                ("composed_worker", train_kernels + ("flash_fwd",
                                                     "paged_decode"),
                 (("operator_attach", lambda: phase_operator_attach(
                     workdir, card)),
                  ("operator_busy", lambda: phase_operator_busy(
                      done["operator_attach"])),
                  ("operator_request", lambda: phase_operator_request(
                      workdir, card)),
                  ("operator_remote", lambda: phase_operator_remote(
                      workdir, card)),
                  ("composed_worker", lambda: phase_composed_worker(
                      gen, done["operator_remote"])),
                  ("operator_request_busy", lambda: phase_operator_busy(
                      done["operator_request"], "operator_request_busy")),
                  ("operator_remote_busy", lambda: phase_operator_remote_busy(
                      done["operator_remote"])))),
                ("operator_ha", ("flash_fwd", "paged_decode"),
                 (("operator_ha", lambda: phase_operator_ha(
                     workdir, card, gen)),
                  ("operator_ha_busy", lambda: phase_operator_ha_busy(
                      done["operator_ha"])))),
                ("operator_fleet", ("flash_fwd", "paged_decode"),
                 (("operator_fleet", lambda: phase_operator_fleet(
                     workdir, card, gen)),
                  ("operator_fleet_busy", lambda: phase_operator_fleet_busy(
                      done["operator_fleet"])))),
                ("operator_binary", ("flash_fwd", "paged_decode"),
                 (("operator_binary", lambda: phase_operator_binary(
                     workdir, card, gen, seed)),
                  ("operator_binary_busy", lambda: phase_operator_binary_busy(
                      done["operator_binary"]))))):
            _reset_counts()
            for phase_name, fn in phases:
                done[phase_name] = timed_phase(phase_name, fn)
            paths[name] = _counts()
            for phase_name in ("mesh_train", "pipeline_train",
                               "reshard_train", "composed_worker",
                               "operator_binary"):
                if phase_name in dict(phases):
                    for k, v in done[phase_name]["launches"].items():
                        paths[name][k] += v
            check(all(paths[name][k] > 0 for k in kernels),
                  f"a kernel of the {name} path was never launched:"
                  f" {paths[name]}")
    finally:
        for w in worlds.values():
            w.close()
        for phase_name in ("operator_attach", "operator_request",
                           "operator_remote", "operator_ha",
                           "operator_fleet"):
            if phase_name in done:
                done[phase_name]["manager"].stop()
        if "operator_remote" in done:
            done["operator_remote"]["server"].close()
        if "operator_binary" in done:
            done["operator_binary"]["world"].stop()
        shutil.rmtree(workdir, ignore_errors=True)
    emit("timing", wall_s=time.perf_counter() - t_start, phase_s=seconds)
    emit("launches", **paths)

    def row(name, source, replaces, function, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "function": function,
                "launches": sum(c[name] for c in paths.values()),
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "issue_ms": t["issue_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("flash_fwd", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:189",
            "attention.py::_fwd_kernel_nolse", flash),
        row("flash_fwd_lse", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:83",
            "attention.py::_fwd_kernel", bwd["flash_fwd_lse"]),
        row("flash_bwd_dq", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:285",
            "attention.py::_dq_kernel", bwd["flash_bwd_dq"]),
        row("flash_bwd_dkv", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:324",
            "attention.py::_dkv_kernel", bwd["flash_bwd_dkv"]),
        row("paged_decode", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:49",
            "paged_attention.py::_kernel", paged["bf16"]),
        row("paged_decode_int8", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:41",
            "paged_attention.py::_kernel_quant", paged["int8_q_bf16"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
