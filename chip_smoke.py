#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gfedntm_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1 and 2: iterate on the kernels
    python3 chip_smoke.py --kernels-only --against DIR  # and K1-K3 bitwise vs DIR's build
    python3 chip_smoke.py --data-parallel-only  # phases 1 and 6
    python3 chip_smoke.py --phase-7-only  # phases 1 and 7
    python3 chip_smoke.py --ctm-only      # phases 1 and 8
    python3 chip_smoke.py --federation-only  # phases 1 and 9
    python3 chip_smoke.py --server-planes-only  # phases 1 and 10
    python3 chip_smoke.py --privacy-ops-only  # phases 1 and 11
    python3 chip_smoke.py --pacing-only   # phases 1 and 12
    python3 chip_smoke.py --hierarchy-only  # phases 1 and 13
    python3 chip_smoke.py --serving-only  # phases 1, 9 and 14
    python3 chip_smoke.py --cli-only      # phases 1 and 15
    python3 chip_smoke.py --scenarios-only  # phases 1 and 16
    python3 chip_smoke.py --mesh-only     # phases 1 and 17
    python3 chip_smoke.py --experiments-only  # phases 1 and 18
    python3 chip_smoke.py --lint-only     # phase 19

Nineteen phases, each fatal on failure (exit code 1; 2 when there is no CUDA
device or no port next to this script). In a run of every phase, phase 4
runs the rank programs of phases 4 to 8 (4(a)-(c), (f), 5(d), 6(a)-(b),
7(a) and 8(c)) in one rank group per world size, two ranks and four, so a
group's start-up, warm-up and teardown are paid twice rather than ten times;
each phase checks its programs' results where it did before. Phases 17, 18
and 19 run beside earlier phases (their text says how). Every phase prints
its seconds.

1. build — compile the fused decoder's CUDA kernels from
   ``gfedntm_tpu_torch/ops/csrc/`` with nvcc for sm_90a; print ptxas'
   registers and spills per kernel (a spill in a tensor-core kernel fails)
   and, from ``cuobjdump -sass``, the tensor-core instructions (HMMA/HGMMA)
   in each ``stats_kernel``, ``loss_kernel`` and ``grads_kernel``
   instantiation, FP32 and bf16 storage, none of which may have 0;
2. kernels — run K1 (stats), K2 (loss) and K3 (grads) at the slice's shapes
   (B=256, K=50, V=100,000), at B=320 (16-column tiles), at V=99,999 (the
   4-byte cp.async ring at full width), at V=66,001 (phase 7(b)'s shape,
   V % 4 = 1, training and eval), at B=64 / B=200 with V=3001 and at
   B=1100, K=8 (K1 and K2 on their CUDA-core route; K3 refuses that batch),
   in training and eval, with masked rows, an all-zero document row and an
   all-masked batch, and hold each against its plain PyTorch version on the
   card; print each case's routes; time kernel and plain version on both
   ring variants; print each kernel's and each plain version's error against
   a float64 plain run at the slice's shapes; check the autograd function
   against the unfused oracle on a small input. ``--against DIR`` also
   builds the fused decoder source of the checkout in DIR and requires its
   FP32 K1, K2 and K3 outputs to be bitwise equal to this build's in every
   case. Then the bf16-storage instantiations (:data:`BF16_CASES`: the
   slice's shape, V=99,999 at a padded pitch, eval, all rows masked, both
   tile widths, K2's tensor-core route past FP32's, the CUDA-core route at
   B=512 and B=1100) against their plain versions on the bf16-rounded beta
   and x, and their times beside the FP32 kernels' and the cast and pad's;
3. main path — federated ProdLDA through the user entry points
   (``AVITM`` -> ``FederatedTrainer.fit`` -> ``make_global_model`` ->
   ``get_topics``) at V=100,000, K=50, H=(100, 100), B=256, 2 clients,
   2 epochs (8 global steps), with the launch counters reset just before
   ``fit`` and read just after; then the same with ``compute_dtype=
   "bfloat16"`` (16 launches of each bf16 instantiation, float32 state
   equal across clients, step losses within 2% of the float32 run's and
   corr(beta_bf16, beta_f32) > 0.98); steady ms per step of both; the model
   FLOPs of one client step (``AVITM.step_flops``) equal to the analytic
   count, and the trainer's ``mfu`` gauge of a 24-step fit in segments of 4;
4. sharded — V-sharded (model-parallel) training in spawned ranks
   (``gfedntm_tpu_torch.parallel``): NCCL with one GPU per rank when there
   are enough GPUs, else gloo with every rank on ``cuda:0`` (the line says
   which). (a) K5 ``prodlda_recon_loss_vsharded`` at B=256, K=50, V=100,000
   over mp=2 and at B=64, V=3002 over mp=2 and dp=2 x mp=2, training and
   eval, masked rows and an all-masked batch, held against the full-V
   kernels and its plain version; (b) ``fit_sharded`` at V=100,000, K=50,
   H=(100, 100), B=256, 2,048 documents, 2 epochs (16 steps), dp=1 x mp=2,
   with each rank's launch counters reset just before and read just after,
   against an unsharded ``AVITM.fit`` on the card (first-step gradients,
   step losses, and beta against the spread that reduction order alone
   gives: an unsharded fit through the unfused decode); (c) teacher-forced
   steps: at steps 1, 4, 8 and 16 of the unsharded split-encoder fit, that
   fit's state, batch and noise go through both the mp=2 ranks and an
   unsharded model, and each leaf's worst gradient error is printed;
   (d) per-rank op time and steady ms per step of the sharded fit;
   (f) ``fit_sharded`` of a bf16 model, 1 epoch (8 steps), each rank's
   bf16 launches counted, against the unsharded bf16 fit (first-step
   gradients within 1e-2 of the largest gradient, each leaf's error over its
   own max|grad| printed; step losses within 1e-2 relative); K5 on bf16
   storage is among (a)'s cases;
5. persistence and validation, at V=100,000, K=50, H=(100, 100), B=256
   (checkpoints under ``build/chip_smoke``, removed afterwards): (a)
   ``AVITM.fit`` of 1,024 documents with 256 validation documents and a
   ``save_dir``, 3 epochs: finite validation losses, ``epoch_*.npz``/``.json``
   on every improvement, and a fresh ``AVITM.load`` of each saved epoch
   bitwise equal to the model as saved (state, topic-word matrix, eval loss
   with injected noise); the validation epoch's ms beside the training
   epoch's; (b) ``FederatedTrainer.fit`` of 2 clients x 1,024 documents, 8
   steps, ``checkpoint_every=4``, interrupted by its segment callback at step
   8 and resumed from step 4 in a fresh trainer, bitwise equal to the
   uninterrupted run, in float32 and bf16, with the checkpoint's size and
   write/restore ms; the uninterrupted float32 run bitwise equal to phase
   3's plain one; (c) that run's metrics records, all valid, and
   ``docs_per_s``; (d) ``fit_sharded`` with 256 validation documents at dp=1
   x mp=2 as in phase 4, 2 epochs: per rank, eval-mode K1 and K2 launches
   through K5 and K3's count left to the training steps; every validation
   loss within 1e-4 of the unsharded unfused eval teacher-forced from the
   same state, generator state and schedule; the same decisions on both
   ranks; rank 0's checkpoints loading into an unsharded ``AVITM`` equal to
   the gathered state. Then eval-mode K1 and K2 at one rank's shard
   (B=256, K=50, V=50,000) against their plain versions, timed beside their
   bounds (rows ``stats_eval`` and ``loss_eval``, launches from (d));
6. data parallel, four gloo ranks on the card (NCCL on four cards), V=100,000,
   K=50, H=(100, 100), B=256, 2,048 documents, dropout 0.2 with live noise:
   (a) ``fit_sharded`` at dp=2 x mp=2, one epoch (8 steps) and its
   validation on 256 documents: per rank K3 0 launches (training takes K5's
   rows-sharded branch, 8 calls), K1, K2 and K5 one eval-mode launch each;
   against the unsharded fused fit on the card: first-step gradients within
   1e-3 of each leaf's max|grad|, step losses within 1e-3, beta within 1.5x
   an unsharded unfused witness's spread (or 4 lr), validation within 1e-4
   of the teacher-forced unsharded eval, the state bitwise equal on all four
   ranks; (b) ``fit_data_sharded`` at dp=2, unfused, 8 steps, against the
   unsharded unfused fit: first-step gradients within 1e-3 of each leaf's
   max|grad|, step losses within 1e-4 relative, beta within 1e-4 but for no
   more entries than an unsharded witness (the fused fit against the
   unfused one) has beyond 1e-4, times 1.5, and its ``flops_per_step``
   equal to the analytic count, with the mfu of its steady step;
   each with its steady ms per step per rank and the bytes per step of its
   batch gather and gradient sum, beside the card's name and power limit;
7. the unfused and LDA decodes at mp > 1, and the flow from raw text:
   (a) ``fit_sharded`` of unfused prodLDA at dp=1 x mp=2 and of LDA at
   dp=1 x mp=2 and dp=2 x mp=2 (gloo ranks on the card, NCCL on enough
   cards), phase 6's corpus and widths, dropout 0, one epoch (8 steps) and
   its validation on 256 documents, each against the unsharded fit of its
   model type on the card: first-step gradients within 1e-3 of each leaf's
   max|grad| (the leaves that cancel in exact arithmetic within 1e-5 of the
   largest, or twice an unsharded split-encoder witness's distance), step
   losses within 1e-4 relative, beta within 1e-4 but for no
   more entries than 1.5x an unsharded split-encoder witness has beyond
   1e-4 (+ 1e-4) and none further than 1.5x its largest (or 4 lr),
   validation within 1e-4 of the teacher-forced unsharded eval, the state
   bitwise equal on every rank, no kernel launched (K1-K3, K5, eval and
   rows-sharded counts all 0, printed), steady ms per step per rank, and
   where a rank group's seconds go (start-up, each fit's set-up, first
   step, fit and timed steps, teardown); the ranks map the corpus from a ``.npy`` file
   (``shared``; phases 4 to 6 too) rather than each receiving a pickled
   copy;
   (b) ``generate_synthetic_corpus(vocab_size=100,000, n_topics=50,
   n_docs=1024, n_nodes=2, materialize_docs=True)``'s token-string documents
   as ``RawCorpus`` clients -> ``run_vocab_consensus(max_features=None)``
   (the native BoW library built; V must be 66,001 and each client's BoW
   the synthetic BoW's columns in the vocabulary's order); K1-K3 on the
   first client's first batch at V=66,001 (theta from an initial model's
   encoder) against their plain versions -> ``AVITM``
   (K=50, H=(100, 100), B=256) -> ``FederatedTrainer.fit``, 2 epochs, with
   the launch counters reset just before and read just after (16 launches
   of each of K1-K3, K2 and K3 on the 4-byte ring since V % 4 = 1) ->
   ``make_global_model`` -> ``get_topics(10)`` -> ``npmi_coherence`` and
   ``topic_diversity`` over the clients' tokenised documents (finite, in
   [-1, 1] and [0, 1]); consensus s, vectorize s, steady ms per global step
   and docs/s, beside the card's name and power limit;
8. the CTM family and the externally-stepped clients (every check fatal):
   (a) 7(b)'s two raw-text clients (V=66,001) with 768-d
   ``hashing_embedder`` embeddings and seeded one-hot labels (L=5) ->
   ``CombinedTM`` (K=50, H=(100, 100), B=256) -> ``FederatedTrainer.fit``,
   8 steps, in float32 and in bf16, the launch counters reset just before
   and read just after (16 launches of each of K1-K3), K1-K3 on the path's
   first batch against their plain versions, shared state bitwise equal
   across clients, the global model's topics, NPMI and diversity, a
   bitwise ``save``/``load`` round trip, steady ms per global step and
   docs/s (24-step fit minus 8-step fit); (b) ``ZeroShotTM`` without labels
   on the same clients, 8 steps: 16 launches of each of K1-K3, finite epoch
   losses that fall; (c) ``fit_sharded`` of CombinedTM with labels on phase
   4's corpus (V=100,000, 2,048 documents, seeded normal embeddings),
   8 steps, at dp=1 x mp=2 (K5: 8 launches of K1-K3 and K5 per rank) and
   dp=2 x mp=2 (K5's rows-sharded branch, 8 calls, no kernel): first-step
   gradients within 1e-3 of each leaf's max|grad| of the unsharded
   CombinedTM's, step losses within 1e-3, the state bitwise equal on every
   rank, steady ms per step per rank; (d) two ``FederatedCTM`` steppers on
   (a)'s model and data, then two ``FederatedAVITM`` steppers on phase 3's
   data, 8 exchanged steps each through ``weighted_mean``: the
   ``StepStatus`` sequences, shared state bitwise equal after every
   ``delta_update_fit``, 16 launches of each of K1-K3, and ms per exchanged
   step split into step, snapshot (with its device-to-host bytes), mean and
   set.
9. the gRPC federation (every check fatal): a port ``FederatedServer`` at
   the JAX server's defaults (update gate, divergence guardian, a journal
   write per round, round checkpoints, the aggregation plane on the card)
   and two port ``Client``s over localhost gRPC in this process, on the card,
   on 7(b)'s raw-text clients (each client's own vocabulary offered to the
   server's consensus: V=66,001), K=50, H=(100, 100), B=256, 2 epochs (8
   global steps), the launch counters reset just before the clients start
   and read after they stop (16 launches of each of K1-K3); K1-K3 on the
   first client's first batch against their plain versions; the shared
   state bitwise equal across clients after every aggregate; every step
   loss, StepStatus and state bitwise equal to the same two
   ``FederatedAVITM`` steppers driven in process through
   ``weighted_mean``; ``server_model.npz`` written; ms per global step
   split into client step, snapshot and encode, transfer and decode (with
   the gate), mean, push and set, and the journal write (median over steps
   2-8), and the bytes each way per step and client.
10. the server's planes (every check fatal): (b) a port server at the JAX
   defaults but ``checkpoint_every=2`` (8 steps hold no 25th), under the
   delta codec, two port clients on 7(b)'s corpora, K=50, H=(100, 100),
   B=256, 8 global steps; the server aborted after round 4 and its
   training thread joined, a replacement on the same ``save_dir``
   recovering from the journal (a round >= killed - 1) and both clients
   reconnecting by session token (2 session restores, no
   ``codec_ref_miss``), 8 aggregates per client bitwise equal across
   clients, finite betas, K1-K3 launched once per local step the steppers
   took and held to their plain versions on the first batch; the journal
   and checkpoint writes' ms, ``maybe_autorecover``'s s, the seconds from
   the restart to the first recovered round and the ms per global step
   before and after the kill. (a) The aggregation plane at full width
   (D = 10,052,752): phase 9's two client snapshots (10(b)'s under
   ``--server-planes-only``), an honest perturbation, one scaled by 100
   and one with a NaN, through ``DeviceAggEngine`` on the card against
   the numpy oracle: the weighted mean bitwise, the gate's norms within
   1e-6 relative of ``update_norm`` with the same admissions, trimmed
   mean and median (N=5 and N=4) within 1e-6, Krum's distances within
   1e-6 of the gram's scale of the exact (float64) ones with numpy's
   Krum selection; each one's ms beside numpy's.
11. the privacy and observation planes (every check fatal): (a) a port
   server at the JAX defaults with ``dp="server"`` (``dp_clip=1.0``,
   ``dp_sigma=0.01``, a ``dp_budget`` crossed at the fifth round), the
   quality plane with its guard (``quality_every=1``, ``quality_ref`` the
   clients' documents), the ops endpoint with two SLOs (one holds, one
   fires) and ``dump_dir`` plus a ``MetricsLogger`` on every node, two port
   clients on 7(b)'s corpora (V=66,001), K=50, H=(100, 100), B=256, 8
   global steps: finite losses, the shared state bitwise equal across
   clients after every aggregate, 16 launches of each of K1-K3 and K1-K3
   within tolerance on the first batch, the ledger's epsilon after each
   round equal to the accountant replayed at q=1, one noise application per
   round on the card, one ``quality_computed`` per round and no quality
   error, every ops route answering 200 during the run, ``/status`` with
   ``privacy`` and ``model_quality``, the fleet naming all three nodes,
   only the firing SLO fired, one ``privacy_budget_exceeded``, and two
   incidents each with the server's bundle and both clients' solicited
   rings; (b) the same federation under ``dp="client"``: one
   ``dp_noise_applied`` per uplink on each client with consecutive
   indices, a host replay of one captured sanitizer application bitwise
   the tensors on the wire, the server's ledger at q=1 and no server noise;
   (c) ``DeviceAggEngine.noise_vector`` at D = 10,052,752: two draws at one
   (seed, index) bitwise equal, |corr| < 2e-3 between neighbouring
   indices, the mean within 2e-3 std of 0 and the std within 1e-3
   relative. Each plane's ms per round (noise on the card beside
   ``host_noise_vector``, the quality step, contribution stats, the
   ``/metrics`` render, fleet ingest, incident captures) and the ms per
   global step beside phase 9's.
12. cohort, async and push pacing, and the simulated fleet (every check
   fatal): three port clients over localhost gRPC on the card, phase 7(b)'s
   two raw-text clients and a third from the same generator with its own
   seed (``seed=1``; the consensus V printed), K=50, H=(100, 100), B=256,
   2 epochs, each federation on a port server at the JAX defaults but for
   its pacing: (a) ``cohort:2`` under the delta codec with
   ``pacing_seed=1``: every ``cohort_sampled`` roster the sampler replayed
   for its (seed, round, eligible), rotating rosters, no quorum skip and no
   ``codec_ref_miss``, every recipient of round r holding the server's
   round-r downlink view bitwise; (b) ``async:2`` with
   ``staleness_alpha=0.5``: every discount ``1/(1+s)^0.5`` for its s;
   (c) ``push:2`` under the delta codec, each client's round 16 local
   steps (``local_steps=16``), 32 epochs: one push received per round, at
   least 8 ``push_aggregated``, no ``codec_ref_miss``,
   ``/status`` pacing ``push:2`` with ``push: true``. In each of (a)-(c):
   at least 8 aggregations, every client finished with finite losses,
   ``server_model.npz`` finite, K1-K3 launched once per local step the
   clients took and held to their plain versions on the first batch, and
   the ms per aggregation split as phase 9's beside phase 9's ms per global
   step. (d) The simulated fleet (``federation/simfleet.py``) with its
   server on the card: cohort:16 and push:16 at N=100 and N=1,000 (6
   rounds), sync at N=100 (2 rounds), each run's set-up and run seconds,
   bytes per round, loopback calls and peak RSS; cohort's and push's bytes
   per round at N=1,000 within 1.25x of N=100.
13. the relay tier and the round profiler (every check fatal): four port
   clients over localhost gRPC on the card, phase 12's three and a fourth
   from the same generator (``seed=2``; the consensus V printed), K=50,
   H=(100, 100), B=256, under a port root at the JAX defaults
   (``min_clients`` = its direct members), relays 101 (clients 1, 2) and
   102 (clients 3, 4) each terminating two. (a) The four clients flat under
   a root, then under the root and the two relays, default codec, 1 epoch
   (4 local steps a client, 4 root rounds): every
   leaf finished with finite losses, each relay one ``relay_preaggregated``
   per root round with ``admitted`` 2 and ``weight`` its members'
   ``nr_samples`` summed, the root's membership {101, 102}, the four leaves'
   state bitwise equal after every round, the root's first average within
   1e-6 x max|.| of the flat run's, the final beta within 1e-4 of the flat
   run's (or, if Adam carries rounding past it, its spread within 1.5x a
   witness's: the flat run with the clients reversed), K1-K3 launched once
   per leaf local step and held to their plain versions on the first
   batch, client 1's ``RoundProfiler(dir, "2:3")`` with one start, one stop,
   no failure and a trace naming the three kernels; the ms per root round
   split into relay fan-out, relay decode and gate, pre-reduction, upstream
   encode, root decode and mean and re-broadcast beside the flat run's ms
   per global step, and the root's bytes per round in both topologies.
   (b) 2 epochs (8 local steps a client), stopped at the root's eighth
   round; the delta codec, ``relay_grace_rounds=2`` on the root, a
   ``save_dir`` per relay: relay 101 aborted after root round 2 and
   respawned on its address and ``save_dir`` once the grace has expired:
   ``maybe_autorecover`` at a round >= killed - 2, both members restored
   with one Ack 3 reset each, the root's
   ready with ``recovered=True``, rounds over relay 102 alone
   (``live_shards`` 1), no ``codec_ref_miss``, the run finished, and the
   root's ``RoundProfiler(dir, "1:2")`` trace written without failure; the
   seconds from the respawn to its first round. (c) 2 epochs, stopped at
   the root's sixth round: relay 102 aborted after root round 2 for good,
   its members with ``failover_addrs=[root]``:
   ``client_rehomes`` 1 on each, ``member_rehomed`` for both at the root, the run
   finished with the root's live membership {101, 3, 4}; K1-K3 launched
   once per local step in (b) and (c), every leaf stopped with its results
   and finite losses. Relay 101's members' liveness window in (b) is 18 s;
   relay 102's members' in (c) 3 s, their reconnect window 2 s.
14. the serving plane (every check fatal), on phase 9's store and corpora
   (``--serving-only`` runs phase 9 first): (a) a ``ServingPlane``
   (``max_batch`` 64, ``poll_s`` 0.2) on the store turns ready; theta for
   256 documents of client 1 bitwise equal to ``get_theta(noise=0.0)`` of
   the port's template with the journal's average, the same rows in 1-,
   3- and 17-row requests within 1e-6, rows stochastic within 1e-5;
   (b) the cold load's seconds, ms per ``engine.infer`` per bucket (median
   of 20) beside the padded batch's copy to the card and the request's
   protobuf parse and decode, and closed loops over gRPC ``Infer`` at
   concurrency 1, 4 and 16 (p50, p99, docs/s, mean batch fill), no failed
   request, and no launch of K1-K3 from the load to here; (c) a copy of the
   store resumed by a port server autorecovering from its journal with the
   same two clients for 3 global steps while a plane polls the copy under
   load at concurrency 4: at least two swaps, no failed request, no
   worker's round going back, K1-K3 once per local step and held to their
   plain versions on the first batch; then a round journaled with
   ``quality.flagged`` refused while the plane keeps the round before it;
   (d) a port federation with ``solver="rmsprop"`` at V near 5,000, 2
   clients, 2 global steps: finite losses, each client's optimizer state
   the GlobalSetup's bytes and its momentum buffers the bridge's, the
   shared state bitwise equal across the clients.
15. the command line, every node a ``python -m gfedntm_tpu_torch`` process
   of its own on the card (each with its own time limit; every check
   fatal): phase 3's corpus as a reference archive
   (``save_reference_npz``: V=100,000, K=50, 2 x 1,024 documents, seed 0)
   and an INI (K=50, H=(100, 100), B=256, 2 epochs, ``max_features``
   100,000); (a) runs beside (b)'s start-up, then (c) alone.
   (a) ``simulate`` with ``--config``: exit 0, a summary line of
   2 clients, V=100,000, 8 global steps, a finite loss and TSS, and
   ``global_model.npz``'s betas bitwise those of phase 3's float32 fit
   (fitted here under ``--cli-only``); its wall time, ``federated_fit``
   seconds and ``docs_per_s``. (b) A server (``--id 0``, 2 clients, 8
   global steps) and clients 1 and 2 on the archive's nodes (the consensus
   V), client 1 with ``--profile_dir`` over rounds [2, 3): every process
   exits 0, ``server_model.npz`` written, the clients' saved betas bitwise
   equal, client 1's Chrome trace naming ``stats_kernel``, ``loss_kernel``
   and ``grads_kernel``, and ``summarize``, ``trace`` (events of all three
   nodes) and ``report`` over the three streams exiting 0; the median ms per
   global step over rounds 2-8 of the server's ``round`` spans beside phase
   9's, and the bytes each way per step. (c) ``--role serve`` on (b)'s save
   dir: 16 four-document ``Infer`` requests through ``make_infer_stub``, no
   failure, theta rows summing to 1 within 1e-6, ``model_round`` the store's
   newest round, exit 0.
16. the scenario matrix's headline composition (every check fatal): the
   cell ``dir01-crash-cohort`` (Dirichlet alpha = 0.1 over three clients,
   ``cohort:2``, the delta codec, a server aborted after round 3 and a
   replacement that autorecovers with zero flags) at the reference's DSS/TSS
   widths (K=50, H=(100, 100), B=64, a 5,000-word generator, 3,072
   documents) through the port's ``run_matrix`` on ``cuda:0``, which runs
   its no-fault twin first, every node in this process: every contract of
   both cells green, recovery from the journal at a round >= killed - 1, no
   ``codec_ref_miss``, K1-K3 launched once per local step the cells'
   clients took (read from their streams), each bench row and the artifact
   valid under ``scripts/bench_schema.py`` with ``headline_green``, and
   K1-K3 held to their plain versions on client 1's first 64 documents at
   the consensus V (the journal's vocabulary, the server's seeded
   template); V, the route, rounds, seconds, median ms per server round,
   bytes per round and the final NPMI beside the twin's.
17. one client over several devices, and the trainer over client ranks
   (every check fatal): (a) two programs of a rank group of 2 of their own
   (gloo on ``cuda:0`` on a one-card host; in a run of every phase run on a
   thread of this process from the start of phase 13): the data-parallel
   ``FederatedStepper`` of one client of phase 3's corpus (1,024 documents, V=100,000, K=50,
   H=(100, 100), B=256, ``fused_decoder=False``) for 8 local steps, beta
   within 1e-4 of the one-rank stepper's after every step, or within the
   spread of a witness (the one-rank stepper through the fused kernels: no
   larger than 1.5x its max or 4 lr, and no more than 1.5x its entries past
   1e-4, as phases 4 and 6(b) hold beta after Adam), its batch axis
   padded to a multiple of 2, its state bitwise equal on both ranks and no
   kernel launched; and ``FederatedTrainer`` over 2 client ranks at phase
   3's configuration, bitwise equal to phase 3's one-device fit (else within
   1e-6, the reason printed), 8 launches of each of K1-K3 per rank, the
   shared state bitwise equal across ranks, ``federated_mesh_devices`` 2;
   (b) a server, client 1 with ``--mesh_devices 2`` and client 2 on one
   device, each a ``python -m gfedntm_tpu_torch`` process, on phase 15's
   archive and INI (V=66,001), 8 global steps: every process exits 0, the
   clients' betas bitwise equal after the last aggregate, the mesh client's
   ranks bitwise equal (its ``mesh_ranks`` record), K1-K3 in client 2's
   trace and none in the mesh client's (the unfused decode, as the JAX
   mesh client); the median ms per global step beside phase 15(b)'s. In a
   run of every phase, (b)'s processes start in phase 15, once its archive
   is written, and run beside phases 15 and 16, so their seconds are taken
   beside each other.
18. the experiment harnesses (every check fatal): one DSS/TSS iteration of
   ``run_simulation`` at the reference's widths (V=5,000, K=50, H=(100,
   100), B=64, lr 2e-3, 5 nodes, eta 0.01, 10 frozen topics) on ``cuda:0``,
   cut to 2,000 training and 200 held-out documents a node (of 10,000 and
   1,000), 10 epochs (of 100) and one iteration (of 20): every arm's TSS
   and DSS finite, TSS centralized > non-collaborative > random, DSS
   centralized < non-collaborative, K1-K3 once per training step of the six
   fits (each at its corpus's V, its ring printed) and within tolerance of
   their plain versions on the centralized fit's first batch,
   ``results.json`` with the keys of the JAX artifact
   ``results/dss_tss_eta001/results.json`` and ``meta["backend"]`` ``cuda``;
   then ``TMWrapper.train_model`` and ``evaluate_model`` of an AVITM on the
   centralized corpus, its NPMI, inverted RBO and topic diversity finite.
   Each arm's seconds, steps and scores print beside the published means
   (for reading: the run is cut). In a run of every phase, phase 18 runs in
   a process of its own (``spawn``; it counts its own launches) from the
   start of phase 13 and phase 17 waits for it, so its seconds are taken
   beside phases 13-17.
19. the port's static-analysis gate: ``python -m gfedntm_tpu_torch.analysis``
   (graftlint's six rules over the port and this script, against
   ``gfedntm_tpu_torch/analysis/lint_baseline.json``) exits 0 under the
   card's torch build (its GL001 imports the port's ``observability``, and
   so torch). One line: the files scanned, per rule the new, baselined and
   inline-suppressed findings, the lint's own seconds and this process's
   serial cost. Its process starts with the script and is joined before the
   kernels' lines, so its serial cost is the join and the line's breakdown.

Output: the card's name and power limit first; one line per kernel (launch
count, max error and its tolerance, kernel, plain and bound ms); a
``{"kernels": [...]}`` JSON line before the last, after the script's own
seconds; and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

# Published peaks by card (NVIDIA data sheets; dense, no sparsity: half the
# sheets' sparse tensor-core figures): memory bytes/s, FP32 FLOP/s on the
# CUDA cores, and TF32 FLOP/s on the tensor cores. Keys are matched against
# the nvidia-smi name; the SXM part is the default.
_PEAKS = (
    ("H100 NVL", 3.9e12, 60e12, 417.5e12),
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H200", 4.8e12, 67e12, 495e12),
    ("H100", 3.35e12, 67e12, 495e12),
)
# An FP32-accurate product on the tensor cores is three TF32 products
# (3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi).
TF32_PASSES = 3
# TF32 products per FP32-accurate FLOP of each kernel, by storage. A bf16
# operand is exact in TF32 (its lo half is zero), so a product with beta
# takes two: K1's z and K2's z take two, K3's z and g_theta two each and its
# g_beta = theta^T gz three, 7 of its 3 GEMMs' 9.
TF32_PRODUCTS = {
    "float32": {"stats": 3, "loss": 3, "grads": 3},
    "bfloat16": {"stats": 2, "loss": 2, "grads": 7 / 3},
}
RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain: |err| <= ATOL + RTOL * max|plain|
# Gradients that are zero in exact arithmetic (BatchNorm removes a bias; the
# batch mean of the normalized mu is zero): both sides see rounding noise.
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")


class SmokeFailure(Exception):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def check_same_state(res: list, label: str) -> None:
    """The gathered state of a ``programs.fit`` is bitwise equal on every
    rank: world rank 0's state is the one its digest names, and every
    rank's digest equals rank 0's."""
    from gfedntm_tpu_torch.parallel import programs

    want = res[0]["state_digest"]
    check(programs.state_digest(res[0]["state"]) == want,
          f"{label}: rank 0's state is not the one its digest names")
    for rank, r in enumerate(res[1:], 1):
        for key in sorted(set(want) | set(r["state_digest"])):
            check(r["state_digest"].get(key) == want.get(key),
                  f"{label}: {key} differs between rank 0 and rank {rank} after the fit")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    return (out.stdout.strip().splitlines() or [f"nvidia-smi failed: {out.stderr.strip()}"])[0]


def peaks(name: str) -> tuple[float, float, float, str]:
    """(bytes/s, FP32 FLOP/s, TF32 FLOP/s, matched key) of the card."""
    for key, bw, simt, tf32 in _PEAKS:
        if key in name:
            return bw, simt, tf32, key
    return (*_PEAKS[-1][1:], "H100 (assumed)")


def kernel_bound(nbytes: float, nflops: float, card: str,
                 passes: float = TF32_PASSES) -> dict:
    """The least time the card could take for a function that moves
    ``nbytes`` and does ``nflops`` FP32-accurate FLOPs: the larger of the
    bytes over the memory rate and the FLOPs as ``passes`` TF32 products
    each (3xTF32; fewer on bf16 operands, :data:`TF32_PRODUCTS`) over the
    tensor cores' dense TF32 rate; and, for the record, the FP32 SIMT bound
    (FLOPs over the CUDA cores' FP32 rate instead)."""
    bw, simt, tf32, key = peaks(card)
    t_bytes = nbytes / bw * 1e3
    t_ops = passes * nflops / tf32 * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops,
        "simt_bound_ms": max(t_bytes, nflops / simt * 1e3), "peaks": key,
    }


def model_step_flops(b: int, v: int, k: int, hidden: tuple) -> int:
    """The analytic model FLOPs of one training step of an AVITM: the
    forward's GEMMs 2·B·(V·H1 + sum H_i·H_i+1 + 2·H_last·K + K·V), times
    three (forward, input and weight gradients), less the input layer's
    input gradient, which no step computes (``utils/flops.py``)."""
    widths = (v,) + tuple(hidden)
    fwd = sum(a * c for a, c in zip(widths, widths[1:])) + 2 * widths[-1] * k + k * v
    return 3 * 2 * b * fwd - 2 * b * v * hidden[0]


@functools.lru_cache(maxsize=None)
@functools.cache
def synthetic_bow(vocab_size: int, n_topics: int, n_docs: int, seed: int):
    """One node's BoW of ``generate_synthetic_corpus`` (no documents), made
    once per script run: phases 4 to 8 train on the same corpora (the same
    array, so :func:`shared` writes its ``.npy`` once). Callers only read
    it."""
    from gfedntm_tpu_torch import generate_synthetic_corpus

    return generate_synthetic_corpus(vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs,
                                     n_nodes=1, materialize_docs=False, seed=seed).nodes[0].bow


CORPORA = Path(__file__).resolve().parent / "build" / "chip_smoke_corpora"
_SHARED: dict[int, tuple[object, str]] = {}


def shared(X) -> str:
    """The path of a ``.npy`` copy of ``X`` under :data:`CORPORA`, written
    once per array: spawned ranks map it (``programs.corpus``) instead of
    each receiving a pickled copy through its spawn pipe, which the parent
    fills one rank at a time. ``main`` removes the directory."""
    import numpy as np

    if id(X) not in _SHARED:
        CORPORA.mkdir(parents=True, exist_ok=True)
        path = CORPORA / f"corpus_{len(_SHARED)}.npy"
        np.save(path, X)
        _SHARED[id(X)] = (X, str(path))  # the reference keeps id(X) unique
    return _SHARED[id(X)][1]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 1: what the build made
# ---------------------------------------------------------------------------
def _kernel_name(mangled: str) -> str:
    """``stats_kernel<32, 16B>``, ``stats_kernel<bf16, 32, 16B>`` etc. from a
    mangled name (the CUDA-core ``simt_stats_kernel``, ``<bf16>`` for its bf16
    instantiation, and the fold kernels as they are)."""
    found = re.search(r"((?:simt_)?(?:stats|loss)_kernel|grads_kernel|merge_softmax_kernel|"
                      r"fold_rows_kernel|sum_partials_kernel)"
                      r"(?:I(f|13__nv_bfloat16)?(?:Li(\d+)ELb([01])E)?E)?", mangled)
    if not found:
        return mangled
    name, storage, width, vec16 = found.groups()
    args = ["bf16"] if storage == "13__nv_bfloat16" else []
    if width:
        args += [width, "16B" if vec16 == "1" else "4B"]
    return f"{name}<{', '.join(args)}>" if args else name


TENSOR_CORE_FAMILIES = ("stats_kernel", "loss_kernel", "grads_kernel")


def check_tensor_core_counts(counts: dict) -> None:
    """Every instantiation of each tensor-core kernel family has at least one
    HMMA/HGMMA instruction, and each family has an FP32 and a bf16-storage
    instantiation."""
    for family in TENSOR_CORE_FAMILIES:
        for storage, want in (("FP32", False), ("bf16", True)):
            check(any(name.startswith(family + "<") and name.startswith(family + "<bf16") == want
                      for name in counts),
                  f"cuobjdump found no {storage} {family} instantiation among {sorted(counts)}")
    for name, n in counts.items():
        check(n > 0, f"{name}: no HMMA/HGMMA instruction in its SASS")


def ptxas_report(build_log: str) -> tuple[list[str], dict]:
    """ptxas' register and spill lines per kernel, and the spilled bytes
    (stores + loads) per kernel."""
    lines, spills, current = [], {}, None
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = _kernel_name(entry.group(1))
        elif current and ("registers" in line or "spill" in line):
            lines.append(f"ptxas {current}: {line.strip().removeprefix('ptxas info    : ')}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                spills[current] = spills.get(current, 0) + int(spill[1]) + int(spill[2])
    return lines, spills


def build_report(lib: Path, build_log: str) -> list[str]:
    """Prints ptxas' registers and spills per kernel (when this process built
    the library; a tensor-core kernel that spills then fails), and returns
    the line of tensor-core instructions (HMMA, HGMMA) that ``cuobjdump
    -sass`` finds in each instantiation of K1, K2 and K3
    (:func:`check_tensor_core_counts`). Fails when there is no cuobjdump to
    look."""
    lines, spills = ptxas_report(build_log)
    if not build_log:
        lines.append("ptxas: library up to date, not rebuilt in this process")
    for line in lines:  # before any check, so that a failing build shows them all
        print(f"build: {line}", flush=True)
    for name, nbytes in spills.items():
        check(nbytes == 0 or not name.startswith(TENSOR_CORE_FAMILIES),
              f"{name}: ptxas reports {nbytes} bytes of spill stores and loads")
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    check(Path(tool).exists(), f"cuobjdump not found ({tool}): cannot count tensor-core "
          "instructions")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=False)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr.strip()}")
    counts, current = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            current = name if name.startswith(TENSOR_CORE_FAMILIES) else None
            if current:
                counts[current] = 0
        elif current and re.search(r"\bH(G)?MMA\b", line):
            counts[current] += 1
    check_tensor_core_counts(counts)
    return ["tensor-core instructions (HMMA/HGMMA in cuobjdump -sass): " + ", ".join(
        f"{name} {n}" for name, n in sorted(counts.items()))]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_inputs(b, k, v, seed, mask_kind):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    theta = torch.softmax(torch.randn(b, k, generator=gen, device=dev), dim=1)
    beta = torch.randn(k, v, generator=gen, device=dev)
    x = torch.randint(0, 4, (b, v), generator=gen, device=dev).float()
    run_mean = 0.1 * torch.randn(v, generator=gen, device=dev)
    run_var = 0.5 + 1.5 * torch.rand(v, generator=gen, device=dev)
    mask = torch.ones(b, device=dev)
    if mask_kind == "partial":
        mask[::7] = 0.0  # some masked rows
        x[1].zero_()  # an all-zero document
    elif mask_kind == "all":
        mask.zero_()
    g_rl = torch.linspace(0.1, 2.0, b, device=dev)
    return dict(theta=theta, beta=beta, x=x, run_mean=run_mean, run_var=run_var,
                mask=mask, g=(g_rl * mask).contiguous())


def compare(name, got, want, case):
    """Max |kernel - plain| over the outputs named in ``name``; fails above
    ATOL + RTOL * max|plain|. Softmax-max sentinels (-1e30, fully-masked
    rows) must match exactly and are left out of the scale."""
    import torch

    torch.cuda.synchronize()
    worst = 0.0
    for label, a, b in zip(name.split(","), got, want):
        check(bool(torch.isfinite(a).all()), f"{case}: {label} not finite")
        sentinel = b.abs() >= 1e29
        check(torch.equal(a[sentinel], b[sentinel]), f"{case}: {label} sentinel rows differ")
        a, b = a[~sentinel], b[~sentinel]
        if b.numel() == 0:
            continue
        err = float((a - b).detach().abs().max())
        tol = ATOL + RTOL * float(b.detach().abs().max())
        check(err <= tol, f"{case}: {label} max |err| {err:.3e} > tol {tol:.3e}")
        worst = max(worst, err)
    return worst


def kernel_work(b, k, v, storage="float32") -> dict:
    """Per kernel: (bytes, each input read once and each output written
    once; FP32-accurate FLOPs). ``storage="bfloat16"``: beta and x read as
    2 bytes a value (at V, not at the padded pitch); everything else 4."""
    f4, fs = 4.0, 2.0 if storage == "bfloat16" else 4.0
    bk, kv, bv = b * k, k * v, b * v
    return {
        "stats": (f4 * (bk + b + 2 * v + 2 * b) + fs * kv, 2.0 * b * k * v),
        "loss": (f4 * (bk + 2 * v + 2 * b + 2 * b) + fs * (kv + bv), 2.0 * b * k * v),
        "grads": (f4 * (bk + 2 * v + 5 * b + bk + kv) + fs * (kv + bv), 6.0 * b * k * v),
    }


def vsharded_work(b, k, v, mp, storage="float32") -> tuple[float, float, float]:
    """K5 per rank: (bytes, FLOPs, the collectives' share of the bytes) —
    one rank's K1 + K2 + K3 on V/mp, plus what its collectives move (the
    softmax merge and the loss/row-dot sum, [mp, 2, B] each, and the g_theta
    sum, [mp, B, K])."""
    work = kernel_work(b, k, v // mp, storage)
    coll = 4.0 * (mp * 2 * b + mp * 2 * b + mp * b * k)
    return (sum(w[0] for w in work.values()) + coll, sum(w[1] for w in work.values()), coll)


def vsharded_passes(storage="float32") -> float:
    """K5's TF32 products per FP32-accurate FLOP: its kernels' FLOPs
    (2 : 2 : 6) weighted by :data:`TF32_PRODUCTS`."""
    p = TF32_PRODUCTS[storage]
    return (2 * p["stats"] + 2 * p["loss"] + 6 * p["grads"]) / 10


ROUTE_NAMES = {32: "tensor cores, 32-column tiles", 16: "tensor cores, 16-column tiles",
               0: "CUDA cores", -1: "refused"}


def against_library(root: Path):
    """The fused decoder built from the checkout at ``root`` (another commit,
    to compare two builds on one card), loaded beside this one."""
    import ctypes

    from gfedntm_tpu_torch.ops import _build

    source = root / "gfedntm_tpu_torch" / "ops" / "csrc" / "fused_decoder.cu"
    check(source.exists(), f"--against {root}: no {source}")
    library = _build.build(source, _build.BUILD_DIR.parent / "against" / "libfused_decoder.so")
    return _build.declare(ctypes.CDLL(str(library)))


def accuracy_line(st_args, lo_args, gr_args) -> str:
    """Each kernel's and each plain version's max |error| against the plain
    version run in float64 on the same float32 inputs (K2 and K3 take the
    float32 plain statistics, as the comparison above does)."""
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd

    def f64(args):
        return tuple(a.double() if torch.is_tensor(a) else a for a in args)

    parts = []
    for name, labels, kernel, plain, args in (
        ("stats", "mean,var,m,s", fd.stats, fd.stats_reference, st_args),
        ("loss", "loss,rd", fd.loss, fd.loss_reference, lo_args),
        ("grads", "g_theta,g_beta", fd.grads, fd.grads_reference, gr_args),
    ):
        got, ref, exact = kernel(*args), plain(*args), plain(*f64(args))
        torch.cuda.synchronize()
        for label, a, b, e in zip(labels.split(","), got, ref, exact):
            keep = e.abs() < 1e29  # softmax-max sentinels, compared exactly elsewhere
            scale = float(e[keep].abs().max())
            errs = [float((x.double() - e)[keep].abs().max()) for x in (a, b)]
            parts.append(f"{name} {label} {errs[0]:.3e} / {errs[1]:.3e} (max|x| {scale:.3e})")
    return "; ".join(parts)


def kernel_phase(card: str, against: Path | None = None) -> tuple[dict, dict]:
    import torch

    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    lib = _build.load()
    other = against_library(against) if against else None
    cases = [
        (256, 50, 100_000, "partial", True), (256, 50, 100_000, "partial", False),
        (320, 50, 100_000, "partial", True), (256, 50, 99_999, "partial", True),
        (256, 50, 66_001, "partial", True), (256, 50, 66_001, "partial", False),
        (64, 50, 3001, "partial", True), (64, 50, 3001, "partial", False),
        (64, 50, 3001, "all", True), (64, 50, 3001, "all", False),
        (200, 50, 3001, "partial", True), (200, 50, 3001, "none", False),
        (1100, 8, 3001, "partial", True),
    ]
    worst = {"stats": 0.0, "loss": 0.0, "grads": 0.0}
    seen = {"stats": set(), "loss": set()}
    bitwise = 0
    for i, (b, k, v, mask_kind, training) in enumerate(cases):
        t = make_inputs(b, k, v, seed=i, mask_kind=mask_kind)
        case = f"B={b} K={k} V={v} mask={mask_kind} {'train' if training else 'eval'}"
        routes = {name: fd._route(lib, name, b, k) for name in worst}
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], training)
        ref_stats = fd.stats_reference(*st_args)
        got_stats = fd.stats(*st_args)
        worst["stats"] = max(worst["stats"], compare(
            "mean,var,m,s", got_stats, ref_stats, case))
        mean, var, m, s = ref_stats
        lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
        ref_loss = fd.loss_reference(*lo_args)
        got_loss = fd.loss(*lo_args)
        worst["loss"] = max(worst["loss"], compare("loss,rd", got_loss, ref_loss, case))
        if other is not None:
            for name, got, theirs in (
                    ("K1", got_stats, fd._launch_stats(other, *st_args, 1e-5)),
                    ("K2", got_loss, fd._launch_loss(other, *lo_args, 1e-5, 1e-10))):
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, theirs)),
                      f"{case}: {name} differs from the build of {against}")
        for name in seen:
            seen[name].add(routes[name])
        if routes["grads"] >= 0:
            gr_args = lo_args + (ref_loss[1], t["g"], t["mask"], training)
            got = fd.grads(*gr_args)
            worst["grads"] = max(worst["grads"], compare(
                "g_theta,g_beta", got, fd.grads_reference(*gr_args), case))
            if other is not None:
                theirs = fd._launch_grads(other, *gr_args, 1e-5, 1e-10)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, theirs)),
                      f"{case}: K3 differs from the build of {against}")
                bitwise += 1
        print(f"kernels ok: {case}; routes: " + ", ".join(
            f"{name} {ROUTE_NAMES[r]}" for name, r in routes.items()), flush=True)
    for name, routes in seen.items():
        check({32, 16, 0} <= routes, f"{name}: the smoke cases took only the routes "
              f"{sorted(routes)}")
    if other is not None:
        print(f"kernels ok: K1 and K2 bitwise equal to the build of {against} in "
              f"{len(cases)} cases, K3 in {bitwise}", flush=True)

    # The autograd function against the unfused oracle (gradients by
    # autograd through plain ops), on a small input.
    t = make_inputs(64, 50, 3001, seed=99, mask_kind="partial")
    w = torch.linspace(0.1, 2.0, 64, device="cuda")
    outs = []
    for fn in (fd.prodlda_recon_loss, fd.prodlda_recon_loss_reference):
        th = t["theta"].clone().requires_grad_(True)
        be = t["beta"].clone().requires_grad_(True)
        rl, mean, var = fn(th, be, t["x"], t["run_mean"], t["run_var"], t["mask"], True)
        (rl * t["mask"] * w).sum().backward()
        outs.append((rl * t["mask"], mean, var, th.grad, be.grad))
    compare("rl,mean,var,g_theta,g_beta", outs[0], outs[1], "autograd vs oracle")
    print("kernels ok: autograd function vs unfused oracle", flush=True)

    # Timing at the slice's shapes (training, as the main path runs them):
    # V=100,000 takes the 16-byte cp.async ring, V=99,999 the 4-byte one.
    b, k = 256, 50
    rows, notes = {}, {}
    for v in (100_000, 99_999):
        t = make_inputs(b, k, v, seed=0, mask_kind="partial")
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], True)
        mean, var, m, s = fd.stats_reference(*st_args)
        lo_args = (t["theta"], t["beta"], t["x"], mean, var, m, s)
        gr_args = lo_args + (fd.loss_reference(*lo_args)[1], t["g"], t["mask"], True)
        fns = {
            "stats": (lambda: fd.stats(*st_args), lambda: fd.stats_reference(*st_args)),
            "loss": (lambda: fd.loss(*lo_args), lambda: fd.loss_reference(*lo_args)),
            "grads": (lambda: fd.grads(*gr_args), lambda: fd.grads_reference(*gr_args)),
        }
        if v != 100_000:
            for name, (kernel_fn, _) in fns.items():
                ms = [time_ms(kernel_fn) for _ in range(2)]
                notes[name] += f"; at V={v} (4-byte cp.async ring) ms {ms[0]:.4f}/{ms[1]:.4f}"
            continue
        work = kernel_work(b, k, v)
        for name, (kernel_fn, plain_fn) in fns.items():
            # plain, kernel, kernel, plain: compare within one call, in turns.
            p1 = time_ms(plain_fn)
            k1 = time_ms(kernel_fn)
            k2 = time_ms(kernel_fn)
            p2 = time_ms(plain_fn)
            nbytes, nflops = work[name]
            bound = kernel_bound(nbytes, nflops, card)
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": worst[name],
                "ms": min(k1, k2), "plain_ms": min(p1, p2),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": None,
            }
            notes[name] = (
                f"tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms {k1:.4f}/{k2:.4f} "
                f"plain_ms {p1:.4f}/{p2:.4f}; bound {bound['bound_by']} ({bound['peaks']} "
                f"peaks: {nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
                f"{nflops / 1e9:.2f} GFLOP as 3xTF32 -> {bound['ops_ms']:.4f} ms); FP32 SIMT "
                f"bound {bound['simt_bound_ms']:.4f} ms"
            )
        print(f"accuracy at B={b} K={k} V={v} train, max |err| against the plain version in "
              f"float64 (kernel / float32 plain): {accuracy_line(st_args, lo_args, gr_args)}",
              flush=True)
    bf16_kernel_phase(card, lib, rows, notes)
    return rows, notes


# (B, K, V, mask kind, training): the main path's shape, its padded pitch
# (V=99,999), the CTM flow's shape (V=66,001: 7 pad columns), eval, all rows
# masked, 16-column tiles (B=320), K2's tensor-core route past where FP32
# leaves it (B=360: half-size x stages), and the CUDA-core route (B=512, past
# the FP32 route boundary; B=1100).
BF16_CASES = [
    (256, 50, 100_000, "partial", True), (256, 50, 100_000, "partial", False),
    (256, 50, 99_999, "partial", True), (256, 50, 99_999, "none", False),
    (256, 50, 66_001, "partial", True), (256, 50, 66_001, "partial", False),
    (320, 50, 100_000, "partial", True), (360, 50, 20_001, "partial", True),
    (360, 50, 20_001, "partial", False), (512, 50, 20_000, "partial", True),
    (64, 50, 3001, "all", True), (64, 50, 3001, "all", False),
    (1100, 8, 3001, "partial", True),
]
REPLACES = {
    "stats": "gfedntm_tpu/ops/fused_decoder.py:189",
    "loss": "gfedntm_tpu/ops/fused_decoder.py:266",
    "grads": "gfedntm_tpu/ops/fused_decoder.py:612",
}


def bf16_kernel_phase(card: str, lib, rows: dict, notes: dict) -> None:
    """The bf16-storage instantiations of K1, K2 and K3 against their plain
    versions (the FP32 plain versions on the bf16-rounded beta and x) in
    :data:`BF16_CASES`; whether they equal the FP32 kernels on the same
    rounded values bit for bit where both take the same route; their times
    at the main path's shape beside the FP32 kernels' (``rows``) from this
    call; and the wrapper's cast-and-pad of beta and x."""
    import torch

    from gfedntm_tpu_torch.ops import fused_decoder as fd

    bf = "bfloat16"
    worst = {"stats": 0.0, "loss": 0.0, "grads": 0.0}
    seen = {"stats": set(), "loss": set()}
    same_bits, same_route = 0, 0
    for i, (b, k, v, mask_kind, training) in enumerate(BF16_CASES):
        t = make_inputs(b, k, v, seed=200 + i, mask_kind=mask_kind)
        case = f"bf16 B={b} K={k} V={v} mask={mask_kind} {'train' if training else 'eval'}"
        routes = {name: fd._route(lib, name, b, k, bf) for name in worst}
        routes32 = {name: fd._route(lib, name, b, k) for name in worst}
        beta_s, x_s = fd.store(t["beta"], bf), fd.store(t["x"], bf)
        beta_r, x_r = beta_s.float(), x_s.float()  # the values the kernels read
        st = (t["theta"], beta_s, t["mask"], t["run_mean"], t["run_var"], training)
        st_plain = (t["theta"], beta_r) + st[2:]
        ref_stats = fd.stats_reference(*st_plain)
        got = {"stats": fd.stats(*st, storage_dtype=bf)}
        worst["stats"] = max(worst["stats"], compare("mean,var,m,s", got["stats"], ref_stats,
                                                     case))
        mean, var, m, s = ref_stats
        lo_plain = (t["theta"], beta_r, x_r, mean, var, m, s)
        ref_loss = fd.loss_reference(*lo_plain)
        got["loss"] = fd.loss(t["theta"], beta_s, x_s, mean, var, m, s, storage_dtype=bf)
        worst["loss"] = max(worst["loss"], compare("loss,rd", got["loss"], ref_loss, case))
        for name in seen:
            seen[name].add(routes[name])
        gr_rest = (mean, var, m, s, ref_loss[1], t["g"], t["mask"], training)
        if routes["grads"] >= 0:
            got["grads"] = fd.grads(t["theta"], beta_s, x_s, *gr_rest, storage_dtype=bf)
            worst["grads"] = max(worst["grads"], compare(
                "g_theta,g_beta", got["grads"], fd.grads_reference(*lo_plain[:3], *gr_rest),
                case))
        # The FP32 kernels on the same rounded values, uncounted.
        fp32 = {
            "stats": lambda: fd._launch_stats(lib, *st_plain, 1e-5),
            "loss": lambda: fd._launch_loss(lib, *lo_plain, 1e-5, 1e-10),
            "grads": lambda: fd._launch_grads(lib, *lo_plain[:3], *gr_rest, 1e-5, 1e-10),
        }
        for name, out in got.items():
            if routes[name] == routes32[name]:
                theirs = fp32[name]()
                torch.cuda.synchronize()
                same_route += 1
                same_bits += all(torch.equal(a, c) for a, c in zip(out, theirs))
        print(f"kernels ok: {case}; routes: " + ", ".join(
            f"{name} {ROUTE_NAMES[r]}" for name, r in routes.items()), flush=True)
    for name, routes in seen.items():
        check({32, 16, 0} <= routes, f"bf16 {name}: the smoke cases took only the routes "
              f"{sorted(routes)}")
    print(f"kernels: bf16 outputs bitwise equal to the FP32 kernels' on the bf16-rounded "
          f"inputs in {same_bits} of {same_route} launches on the same route", flush=True)

    # Times at the main path's shape, training, with beta and x stored as the
    # main path stores them; plain, kernel, kernel, plain.
    b, k, v = 256, 50, 100_000
    t = make_inputs(b, k, v, seed=0, mask_kind="partial")
    beta_s, x_s = fd.store(t["beta"], bf), fd.store(t["x"], bf)
    st = (t["theta"], beta_s, t["mask"], t["run_mean"], t["run_var"], True)
    mean, var, m, s = fd.stats_reference(t["theta"], beta_s.float(), *st[2:])
    lo = (t["theta"], beta_s, x_s, mean, var, m, s)
    rd = fd.loss_reference(t["theta"], beta_s.float(), x_s.float(), mean, var, m, s)[1]
    gr_rest = (mean, var, m, s, rd, t["g"], t["mask"], True)
    fns = {
        "stats": (lambda: fd.stats(*st, storage_dtype=bf),
                  lambda: fd.stats_reference(t["theta"], beta_s.float(), *st[2:])),
        "loss": (lambda: fd.loss(*lo, storage_dtype=bf),
                 lambda: fd.loss_reference(t["theta"], beta_s.float(), x_s.float(),
                                           *lo[3:])),
        "grads": (lambda: fd.grads(*lo[:3], *gr_rest, storage_dtype=bf),
                  lambda: fd.grads_reference(t["theta"], beta_s.float(), x_s.float(),
                                             *gr_rest)),
    }
    work = kernel_work(b, k, v, bf)
    for name, (kernel_fn, plain_fn) in fns.items():
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        nbytes, nflops = work[name]
        bound = kernel_bound(nbytes, nflops, card, TF32_PRODUCTS[bf][name])
        rows[name + "_bf16"] = {
            "name": name + "_bf16", "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst[name],
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
        }
        notes[name + "_bf16"] = (
            f"bf16 beta and x; tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms "
            f"{k1:.4f}/{k2:.4f} (FP32 kernel in this call {rows[name]['ms']:.4f}) plain_ms "
            f"{p1:.4f}/{p2:.4f}; bound {bound['bound_by']} ({bound['peaks']} peaks: "
            f"{nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, {nflops / 1e9:.2f} GFLOP as "
            f"{TF32_PRODUCTS[bf][name]:.3g} TF32 products -> {bound['ops_ms']:.4f} ms)"
        )
    # The wrapper's cast and pad, once per step: beta [K, V] and x [B, V]
    # from float32 to bf16 at the padded pitch.
    cast_ms = [time_ms(lambda: (fd.store(t["beta"], bf), fd.store(t["x"], bf)))
               for _ in range(2)]
    print(f"kernels: bf16 cast and pad of beta [{k}, {v}] and x [{b}, {v}] per step: "
          f"ms {cast_ms[0]:.4f}/{cast_ms[1]:.4f}", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def main_path_datasets() -> list:
    """Phase 3's two client datasets: ``generate_synthetic_corpus``
    (V=100,000, K=50, 1,024 documents per client, seed 0) as BoW."""
    from gfedntm_tpu_torch import BowDataset, generate_synthetic_corpus

    V, K, C = 100_000, 50, 2
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(
        vocab_size=V, n_topics=K, n_docs=1024, n_nodes=C, materialize_docs=False, seed=0,
    )
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=node.bow, idx2token=idx2token) for node in corpus.nodes]
    print(f"main path: synthetic corpus {C} x {datasets[0].X.shape} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return datasets


def main_path_phase(rows: dict) -> tuple[list, object]:
    """Phase 3; returns the client datasets and the float32 fit's result."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    V, K, B, C = 100_000, 50, 256, 2
    datasets = main_path_datasets()

    def run(num_epochs, compute_dtype="float32"):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                         batch_size=B, num_epochs=num_epochs, compute_dtype=compute_dtype)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(datasets)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    trainer, result, secs = run(num_epochs=2)
    launches = dict(fd.LAUNCHES)
    steps = result.losses.shape[0]
    print(f"main path: fit {steps} global steps x {C} clients in {secs:.3f} s; "
          f"launches {launches}; epoch losses {result.epoch_losses}", flush=True)

    check(result.losses.shape == (8, C), f"losses shape {result.losses.shape} != (8, {C})")
    check(bool(np.isfinite(result.losses).all()), "non-finite federated losses")
    for name, want in (("stats", 16), ("loss", 16), ("grads", 16)):
        check(launches[name] == want, f"{name} launched {launches[name]} times, want {want}")
    for tree in (result.client_params, result.client_batch_stats):
        for key, val in tree[0].items():
            for other in tree[1:]:
                check(torch.equal(val, other[key]), f"{key} differs across clients")
    model = trainer.make_global_model(result, datasets[0])
    topics = model.get_topics(10)
    check(len(topics) == K and all(len(t) == 10 for t in topics),
          "get_topics did not return 50 lists of 10")
    print(f"main path: topic 0 {topics[0]}", flush=True)
    for name in ("stats", "loss", "grads"):
        rows[name]["launches"] = launches[name]

    # bf16 compute from the same seed, read just after its own fit: the
    # main path through the bf16 instantiations, held to float32 state and
    # against the float32 run above.
    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    _, result16, secs16 = run(num_epochs=2, compute_dtype="bfloat16")
    launches16 = dict(fd.LAUNCHES)
    print(f"main path bf16: fit {result16.losses.shape[0]} global steps x {C} clients in "
          f"{secs16:.3f} s; launches {launches16}; epoch losses {result16.epoch_losses}",
          flush=True)
    check(result16.losses.shape == (8, C), f"bf16 losses shape {result16.losses.shape}")
    check(bool(np.isfinite(result16.losses).all()), "non-finite bf16 federated losses")
    for name in ("stats", "loss", "grads"):
        check(launches16[name + "_bf16"] == 16 and launches16[name] == 0,
              f"bf16 main path: {name} launched {launches16[name + '_bf16']} times in bf16 "
              f"(want 16) and {launches16[name]} in float32 (want 0)")
        rows[name + "_bf16"]["launches"] = launches16[name + "_bf16"]
    for tree in (result16.client_params, result16.client_batch_stats):
        for key, val in tree[0].items():
            check(val.dtype in (torch.float32, torch.long), f"bf16 run: {key} is {val.dtype}")
            for other in tree[1:]:
                check(torch.equal(val, other[key]), f"bf16 run: {key} differs across clients")
    rel = float(np.max(np.abs(result16.losses - result.losses) / np.abs(result.losses)))
    betas = [r.client_params[0]["beta"].cpu().numpy().ravel() for r in (result16, result)]
    corr = float(np.corrcoef(*betas)[0, 1])
    print(f"main path bf16 vs float32, same seed: max relative step-loss difference {rel:.3e} "
          f"(limit 2e-2); corr(beta_bf16, beta_f32) {corr:.6f} (limit 0.98)", flush=True)
    check(rel <= 2e-2, f"bf16 step losses differ from float32 by {rel:.3e} (limit 2e-2)")
    check(corr > 0.98, f"corr(beta_bf16, beta_f32) {corr:.6f} <= 0.98")

    # The FLOP count and the trainer's mfu gauge: a 24-step fit in segments
    # of 4 steps (the first segment warms up, the other 20 steps are timed).
    from gfedntm_tpu_torch.utils import flops
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                     num_epochs=6)
    want = model_step_flops(B, V, K, (100, 100))
    got = template.step_flops(datasets[0])
    metrics = MetricsLogger()
    FederatedTrainer(template, n_clients=C).fit(datasets, checkpoint_every=4, metrics=metrics)
    mfu = metrics.registry.gauge("mfu").value
    peak, source = flops.resolve_peak_flops_per_device(template.device)
    print(f"main path FLOPs, {card_line()}: {got:.0f} per client step (analytic {want}), "
          f"{C * got:.0f} per global step; trainer mfu gauge {mfu:.6f} of {peak:.4g} FLOP/s "
          f"({source}, dense BF16), steady {metrics.registry.gauge('docs_per_s').value:.1f} "
          f"docs/s", flush=True)
    check(got == want, f"step FLOPs {got} != the analytic count {want}")
    check(mfu > 0, f"trainer mfu gauge {mfu}")

    # Steady state: after one more warm fit, a 24-step fit minus an 8-step
    # fit cancels the per-fit set-up (client copies, corpus upload) and
    # leaves 16 steady steps; each fit is timed twice and the faster kept.
    for dtype in ("float32", "bfloat16"):
        run(2, dtype)
        secs8 = min(run(2, dtype)[2], run(2, dtype)[2])
        secs24 = min(run(6, dtype)[2], run(6, dtype)[2])
        docs_per_step = C * B
        ms_step = (secs24 - secs8) / 16 * 1e3
        check(ms_step > 0, f"steady-state step time {ms_step:.3f} ms is not positive")
        print(f"main path {dtype}: steady {ms_step:.3f} ms per global step, "
              f"{docs_per_step / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}); "
              f"warm 8-step fit {secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms; "
              f"first 8-step fit {(secs if dtype == 'float32' else secs16) * 1e3:.1f} ms",
              flush=True)
    return datasets, result


# ---------------------------------------------------------------------------
# Phase 4: V-sharded training in spawned ranks
# ---------------------------------------------------------------------------
def split_input_layer(model, parts: int) -> None:
    """Make ``model``'s encoder input layer sum its ``parts`` column blocks,
    each one contiguous GEMM, in block order, and then add the bias: the
    reduction order that V-sharding over ``parts`` ranks gives the encoder,
    without sharding."""
    import types

    import torch.nn.functional as F

    layer = model.model.inf_net.input_layer
    v = layer.weight.shape[1]
    cuts = [i * v // parts for i in range(parts + 1)]

    def forward(self, x):
        blocks = [F.linear(x[:, a:b].contiguous(), self.weight[:, a:b].contiguous())
                  for a, b in zip(cuts[:-1], cuts[1:])]
        out = blocks[0]
        for block in blocks[1:]:
            out = out + block
        return out + self.bias

    layer.forward = types.MethodType(forward, layer)


#: Phase 4(a)'s K5 cases by (dp, mp): [(B, V, mask kind, training, timing
#: reps, storage)].
OP_LAYOUTS = {
    (1, 2): [(256, 100_000, "partial", True, 10, "float32"),
             (256, 100_000, "partial", False, 0, "float32"),
             (64, 3002, "partial", True, 0, "float32"), (64, 3002, "partial", False, 0, "float32"),
             (64, 3002, "all", True, 0, "float32"), (64, 3002, "all", False, 0, "float32"),
             (256, 100_000, "partial", True, 10, "bfloat16"),
             (64, 3002, "partial", False, 0, "bfloat16"), (64, 3002, "all", True, 0, "bfloat16")],
    (2, 2): [(64, 3002, "partial", True, 0, "float32"), (64, 3002, "partial", False, 0, "float32"),
             (64, 3002, "all", True, 0, "float32"), (64, 3002, "all", False, 0, "float32")],
}


def op_cases(specs: list) -> tuple[list, list]:
    """K5's inputs for ``specs`` (one :data:`OP_LAYOUTS` entry) as numpy for
    the ranks, and the full-V kernels' outputs on the card for each."""
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    cases, full = [], []
    for i, (b, v, mask_kind, training, reps, storage) in enumerate(specs):
        t = make_inputs(b, 50, v, seed=100 + i, mask_kind=mask_kind)
        cases.append({**{k: t[k].cpu().numpy() for k in (
            "theta", "beta", "x", "run_mean", "run_var", "mask", "g")},
            "training": training, "reps": reps, "storage": storage})
        th = t["theta"].clone().requires_grad_(True)
        be = t["beta"].clone().requires_grad_(True)
        rl, mean, var = fd.prodlda_recon_loss(th, be, t["x"], t["run_mean"], t["run_var"],
                                              t["mask"], training, storage_dtype=storage)
        (rl * t["g"]).sum().backward()
        _, _, m, s = fd.stats(t["theta"], fd.store(t["beta"], storage), t["mask"],
                              t["run_mean"], t["run_var"], training, storage_dtype=storage)
        full.append(((rl, mean, var, th.grad, be.grad), (m, s)))
    return cases, full


def sharded_op_phase(group: dict) -> tuple[dict, dict]:
    """(a): K5 against the full-V kernels and its plain version, on float32
    and on bf16 storage, from :func:`sharded_calls`' ``op`` programs and
    full-V outputs in ``group``. Returns, by storage, the worst |K5 - full
    kernel| and rank 0's op times with the backend."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.parallel import programs

    f32, bf = "float32", "bfloat16"
    worst, times, outputs = {f32: 0.0, bf: 0.0}, {}, "rl,mean,var,g_theta,g_beta"
    for (dp, mp), specs in OP_LAYOUTS.items():
        full, res = group["op_full"][dp, mp], group[f"op {dp}x{mp}"]
        backend = group[f"layout/{dp * mp}"][0]
        for i, (b, v, mask_kind, training, reps, storage) in enumerate(specs):
            case = (f"K5 dp={dp} mp={mp} B={b} V={v} mask={mask_kind} "
                    f"{'train' if training else 'eval'} {storage}")
            per_rank = [r[i] for r in res]

            def cuda(path, names):
                return [torch.from_numpy(programs.assemble(per_rank, dp, mp, n, path)).cuda()
                        for n in names.split(",")]

            kern = cuda("kernel", outputs)
            worst[storage] = max(worst[storage], compare(outputs, kern, full[i][0],
                                                         case + " vs full-V kernel"))
            compare(outputs, kern, cuda("plain", outputs), case + " vs plain")
            if "m" in per_rank[0]:
                compare("m,l", cuda(None, "m,l"), full[i][1], case + " merged softmax")
            for d in range(dp):
                for m in range(1, mp):
                    for name in ("rl", "g_theta"):
                        check(np.array_equal(per_rank[d * mp + m]["kernel"][name],
                                             per_rank[d * mp]["kernel"][name]),
                              f"{case}: {name} differs across model ranks")
            if reps:
                times[storage] = {"backend": backend, "per_rank": [r["ms"] for r in per_rank]}
            print(f"sharded op ok: {case}", flush=True)
    return worst, times


def forced_records(kw: dict, X, mp: int) -> tuple[list, list]:
    """(c)'s inputs: the state, batch and noise at steps 1, 4, 8 and 16 of
    the unsharded split-encoder fit, and that replay's step losses."""
    from gfedntm_tpu_torch import AVITM
    from gfedntm_tpu_torch.parallel import programs

    witness = AVITM(**kw)
    split_input_layer(witness, mp)
    return programs.trajectory(witness, X, (0, 3, 7, 15))


def forced_phase(kw: dict, X, split_losses: list, records: list, losses: list,
                 sharded: list) -> None:
    """(c) Teacher-forced steps: at steps 1, 4, 8 and 16 of the unsharded
    split-encoder fit (:func:`forced_records`), its state, that step's batch
    and its noise went through the mp ranks (``sharded``, rank 0's
    ``forced_steps``) and go through an unsharded model. Prints each step's
    worst relative gradient error over the leaves (error over the leaf's
    max|grad|) and the cancelling leaves' error over the largest gradient;
    fails past 1e-3 and 1e-5 of those. ``split_losses``: the split-encoder
    fit's step losses, which the trajectory's replay must repeat."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM
    from gfedntm_tpu_torch.parallel import programs

    parts = []
    for rec, (loss, grads) in zip(records, sharded):
        ref_loss, ref = programs.step_gradients(AVITM(**kw), X, state=rec["state"],
                                                step=rec["step"], noise=rec["noise"])
        scale = max(float(np.abs(g).max()) for g in ref.values())
        rel = {n: float(np.abs(grads[n] - g).max()) / float(np.abs(g).max())
               for n, g in ref.items() if n not in DEGENERATE}
        cancel = max(float(np.abs(grads[n] - ref[n]).max()) for n in DEGENERATE) / scale
        leaf = max(rel, key=rel.get)
        parts.append(f"step {rec['step'] + 1}: loss {abs(loss - ref_loss) / abs(ref_loss):.2e}, "
                     f"worst leaf {leaf} {rel[leaf]:.3e}, cancelling leaves {cancel:.2e}")
        check(rel[leaf] <= 1e-3, f"forced step {rec['step'] + 1}: {leaf} gradient differs by "
              f"{rel[leaf]:.3e} of its max|grad| (limit 1e-3)")
        check(cancel <= 1e-5, f"forced step {rec['step'] + 1}: {', '.join(DEGENERATE)} differ "
              f"by {cancel:.3e} of the largest gradient (limit 1e-5)")
    print(f"sharded vs unsharded, teacher-forced from the split-encoder fit's trajectory "
          f"(its replay's step losses equal its fit's: {losses == list(split_losses)[:16]}): "
          + "; ".join(parts), flush=True)


#: Where the dp=1 x mp=2 rank group writes phase 5(d)'s checkpoints (phase 5
#: empties :data:`SCRATCH` before it starts); ``main`` removes it.
SHARDED_SAVE = Path(__file__).resolve().parent / "build" / "chip_smoke_sharded"


def rank_groups(calls: dict) -> dict:
    """Run ``calls`` (``{name: (world size, fn, args)}``, each run as
    ``fn(rank, device, *args)``) in one rank group per world size, one
    program after the other (:func:`programs.run_each`): a group's start-up,
    its first program's warm-up and its teardown are paid once per world
    size, not once per program. Returns each program's per-rank results by
    name, and ``layout/<world size>``: the group's backend and devices."""
    from gfedntm_tpu_torch.parallel import programs
    from gfedntm_tpu_torch.parallel.launch import gpu_layout, run_ranks

    out = {}
    for world in sorted({w for w, _, _ in calls.values()}):
        names = [n for n, (w, _, _) in calls.items() if w == world]
        backend, devices = gpu_layout(world)
        t0 = time.perf_counter()
        res = run_ranks(programs.run_each, world, backend, devices, 2400,
                        args=([calls[n][1:] for n in names],))
        print(f"rank group of {world} ranks: {backend} on {devices}, {', '.join(names)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update({n: [r[i] for r in res] for i, n in enumerate(names)})
        out[f"layout/{world}"] = (backend, devices)
    return out


def sharded_calls(kw: dict, X, Xv) -> tuple[dict, dict]:
    """Phase 4's and 5(d)'s rank programs for :func:`rank_groups`: 4(a)'s K5
    cases at dp=1 x mp=2 and dp=2 x mp=2, 4(b)'s ``fit_sharded`` with 24
    timed steps, 4(c)'s teacher-forced steps, 4(f)'s bf16 fit and 5(d)'s fit
    with validation into :data:`SHARDED_SAVE`; and the inputs their checks
    need."""
    from gfedntm_tpu_torch.parallel import programs

    mp = 2
    records, losses = forced_records(kw, X, mp)
    kw16 = {**kw, "num_epochs": 1, "compute_dtype": "bfloat16"}
    shutil.rmtree(SHARDED_SAVE, ignore_errors=True)
    calls, op_full = {}, {}
    for (dp, m), specs in OP_LAYOUTS.items():
        cases, op_full[dp, m] = op_cases(specs)
        calls[f"op {dp}x{m}"] = (dp * m, programs.vsharded_op, (dp, m, cases))
    calls.update({
        "fit": (mp, programs.fit, (1, mp, kw, shared(X), None, 1, 24)),
        "forced": (mp, programs.forced_steps, (1, mp, kw, shared(X), records)),
        "fit16": (mp, programs.fit, (1, mp, kw16, shared(X), None, 1, 0)),
        "validation": (mp, programs.fit, (1, mp, kw, shared(X), None, 1, 0, shared(Xv),
                                          str(SHARDED_SAVE), 5, 0.0)),
    })
    return calls, dict(op_full=op_full, records=records, forced_losses=losses, kw16=kw16)


def sharded_fit_phase(card: str, rows: dict, notes: dict):
    """(a) through (d): the op checks, then ``fit_sharded`` at full width
    against an unsharded ``AVITM.fit``, its timing, and the ``vsharded``
    row of the kernels line. Its rank programs run in :func:`rank_groups`
    together with those of phases 5(d), 6, 7(a) and 8(c), which follow it in
    every run that has phase 4. Returns the fit's corpus, its settings and
    every group program's per-rank results."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs

    V, K, B, N, mp = 100_000, 50, 256, 2048, 2
    X = synthetic_bow(V, K, N, 0)
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=2, dropout=0.0, seed=0)
    calls, group = sharded_calls(kw, X, synthetic_bow(V, K, 256, 1))
    group.update(rank_groups({**calls, **data_parallel_calls(), **decode_calls(),
                              **ctm_sharded_calls()}))
    backend, devices = group[f"layout/{mp}"]
    worst, op_times = sharded_op_phase(group)

    res = group["fit"]
    print(f"sharded fit: {backend}, dp=1 x mp={mp} on {devices}, {N} docs, V={V}; launches "
          f"per rank {[r['launches'] for r in res]}; epoch losses {res[0]['epoch_losses']}",
          flush=True)
    for rank, r in enumerate(res):
        for name in ("stats", "loss", "grads", "vsharded"):
            check(r["launches"][name] == 16,
                  f"rank {rank}: {name} launched {r['launches'][name]} times, want 16")
        check(len(r["step_losses"]) == 16 and bool(np.isfinite(r["step_losses"]).all()),
              f"rank {rank}: step losses {r['step_losses']}")
    check_same_state(res, "sharded fit")
    topics = res[0]["topics"]
    check(len(topics) == K and all(len(t) == 10 for t in topics),
          "get_topics did not return 50 lists of 10")
    print(f"sharded fit: topic 0 {topics[0]}", flush=True)

    # The same first step and fit unsharded on the card: same seed, schedule
    # and noise.
    ref = AVITM(**kw)
    ref_loss, ref_grads = programs.step_gradients(AVITM(**kw), X)
    loss1, grads1 = res[0]["first_step"]
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    worst_grad = 0.0
    for name, g_ref in ref_grads.items():
        err = float(np.abs(grads1[name] - g_ref).max())
        if name in DEGENERATE:  # zero in exact arithmetic: rounding noise
            bound = 1e-5 * scale
            check(float(np.abs(grads1[name]).max()) <= bound, f"first-step grad {name} "
                  f"{float(np.abs(grads1[name]).max()):.3e} > {bound:.3e}")
            continue
        tol = 1e-3 * float(np.abs(g_ref).max())
        check(err <= tol, f"first-step grad {name}: max |err| {err:.3e} > {tol:.3e}")
        worst_grad = max(worst_grad, err / float(np.abs(g_ref).max()))
    check(abs(loss1 - ref_loss) <= 1e-3 * abs(ref_loss),
          f"first-step loss {loss1} vs unsharded {ref_loss}")
    ref.fit(BowDataset(X=X), n_samples=1)
    # Witnesses without sharding, for beta after 16 Adam steps: the same
    # unsharded fit with the encoder input layer summed over its mp column
    # blocks (the reduction order sharding gives the encoder), and through
    # the unfused decode (other reduction orders in the decoder).
    split = AVITM(**kw)
    split_input_layer(split, mp)
    unfused = AVITM(**kw, fused_decoder=False)
    for model in (split, unfused):
        model.fit(BowDataset(X=X), n_samples=1)
    steps_ref = np.asarray(ref.step_losses)

    def step_err(losses):
        return float(np.max(np.abs(np.asarray(losses) - steps_ref) / np.abs(steps_ref)))

    def spread(beta, beta_ref):
        diff = np.abs(beta - beta_ref)
        return float(diff.max()), float((diff > beta_tol).mean())

    betas = {"plain": ref.model.beta.detach().cpu().numpy(), "sharded": res[0]["state"]["beta"],
             "split": split.model.beta.detach().cpu().numpy(),
             "unfused": unfused.model.beta.detach().cpu().numpy()}
    beta_tol = 1e-3 * float(np.abs(betas["plain"]).max())
    pairs = {(a, b): spread(betas[a], betas[b]) for a, b in (
        ("sharded", "plain"), ("split", "plain"), ("unfused", "plain"), ("sharded", "split"))}
    lr = ref.lr
    max_limit = max(4.0 * lr, 1.5 * pairs["split", "plain"][0])
    frac_limit = 1.5 * pairs["split", "plain"][1] + 1e-4
    print(f"sharded vs unsharded: first step: every gradient within 1e-3 * its max|grad| "
          f"(worst {worst_grad:.3e} relative), {', '.join(DEGENERATE)} within 1e-5 * "
          f"{scale:.3e}; fit: max relative step-loss error {step_err(res[0]['step_losses']):.3e} "
          f"(limit 1e-3); witnesses: split encoder {step_err(split.step_losses):.3e}, unfused "
          f"decode {step_err(unfused.step_losses):.3e}", flush=True)
    print(f"beta after 16 Adam steps (lr {lr:g}), max |diff| and fraction of entries beyond "
          f"1e-3 * max|beta| = {beta_tol:.3e}: " + "; ".join(
              f"{a} vs {b} {m:.3e} ({m / lr:.2f} lr), {f:.5f}" for (a, b), (m, f) in pairs.items())
          + f"; limits for sharded vs plain: max <= max(4 lr, 1.5 x split) = {max_limit:.3e}, "
          f"fraction <= 1.5 x split + 1e-4 = {frac_limit:.5f}; sharded vs split fraction <= "
          f"split vs plain", flush=True)
    check(step_err(res[0]["step_losses"]) <= 1e-3,
          f"step losses differ from the unsharded fit by {step_err(res[0]['step_losses']):.3e}")
    check(pairs["sharded", "plain"][0] <= max_limit,
          f"sharded beta max |diff| {pairs['sharded', 'plain'][0]:.3e} > {max_limit:.3e}")
    check(pairs["sharded", "plain"][1] <= frac_limit,
          f"sharded beta: {pairs['sharded', 'plain'][1]:.5f} of entries beyond {beta_tol:.3e}, "
          f"limit {frac_limit:.5f}")
    check(pairs["sharded", "split"][1] <= pairs["split", "plain"][1],
          f"sharded beta is further from the split-encoder fit ({pairs['sharded', 'split'][1]:.5f}"
          f") than that is from the plain fit ({pairs['split', 'plain'][1]:.5f})")

    forced_phase(kw, X, split.step_losses, group["records"], group["forced_losses"],
                 group["forced"][0])

    ms_step = max(r["step_ms"] for r in res)
    print(f"sharded fit ({backend}, {devices}): steady {ms_step:.3f} ms per step, "
          f"{B / ms_step * 1e3:.1f} docs/s (B={B}, mp={mp}; 24 warm steps of fit_sharded's "
          f"step between barriers, per rank {[round(r['step_ms'], 3) for r in res]} ms)",
          flush=True)

    # (f) bf16 compute: fit_sharded of a bf16 model for one epoch (8 steps)
    # against the unsharded bf16 fit, the launches read per rank.
    kw16, res16 = group["kw16"], group["fit16"]
    steps16 = N // B
    print(f"sharded fit bf16: {backend}, dp=1 x mp={mp}; launches per rank "
          f"{[r['launches'] for r in res16]}; step losses {res16[0]['step_losses']}", flush=True)
    for rank, r in enumerate(res16):
        for name in ("stats", "loss", "grads", "vsharded"):
            check(r["launches"][name + "_bf16"] == steps16 and r["launches"][name] == 0,
                  f"bf16 rank {rank}: {name} launched {r['launches'][name + '_bf16']} times in "
                  f"bf16 (want {steps16}) and {r['launches'][name]} in float32 (want 0)")
        check(bool(np.isfinite(r["step_losses"]).all()), f"bf16 rank {rank}: non-finite loss")
    for key, val in res16[0]["state"].items():
        check(val.dtype in (np.float32, np.int64), f"bf16 sharded fit: {key} is {val.dtype}")
    check_same_state(res16, "bf16")
    ref16 = AVITM(**kw16)
    ref_loss16, ref_grads16 = programs.step_gradients(AVITM(**kw16), X)
    ref16.fit(BowDataset(X=X), n_samples=1)
    loss16, grads16 = res16[0]["first_step"]
    scale16 = max(float(np.abs(g).max()) for g in ref_grads16.values())
    # Each leaf's max |diff| over its own max|grad| (printed) and over the
    # largest gradient of any leaf (checked). In bf16, g_theta reaches the
    # encoder rounded to bf16, and K5 sums its per-rank float32 partials in
    # another order than the full-V K3, so now and then an entry rounds to
    # the neighbouring bf16 value; in a leaf whose gradient is a sum that
    # cancels over the batch, one such entry is about a percent of the
    # leaf's own max. The float32 phase above holds the same code's
    # conventions to 1e-3 of each leaf's own max.
    own, whole = {}, {}
    for name, g_ref in ref_grads16.items():
        diff = float(np.abs(grads16[name] - g_ref).max())
        own[name] = diff / float(np.abs(g_ref).max())
        whole[name] = diff / scale16
    leaf, leaf_all = max(own, key=own.get), max(whole, key=whole.get)
    steps_ref16 = np.asarray(ref16.step_losses)
    loss_err16 = float(np.max(np.abs(np.asarray(res16[0]["step_losses"]) - steps_ref16)
                              / np.abs(steps_ref16)))
    print(f"sharded vs unsharded bf16: first-step loss {abs(loss16 - ref_loss16) / abs(ref_loss16):.3e}"
          f" relative; worst first-step gradient leaf {leaf_all} {whole[leaf_all]:.3e} of the "
          f"largest gradient {scale16:.3e} (limit 1e-2); against each leaf's own max|grad| the "
          f"worst is {leaf} {own[leaf]:.3e}; max relative step-loss error over {steps16} steps "
          f"{loss_err16:.3e} (limit 1e-2)", flush=True)
    check(whole[leaf_all] <= 1e-2, f"bf16 first-step gradient {leaf_all} differs by "
          f"{whole[leaf_all]:.3e} of the largest gradient (limit 1e-2)")
    check(loss_err16 <= 1e-2, f"bf16 sharded step losses differ by {loss_err16:.3e}")

    # (e) The vsharded rows: rank 0's op times at mp=2; the bound is one
    # rank's K1-K3 on V/mp plus the bytes its collectives move.
    for storage, name, launches in (("float32", "vsharded", res[0]["launches"]["vsharded"]),
                                    ("bfloat16", "vsharded_bf16",
                                     res16[0]["launches"]["vsharded_bf16"])):
        nbytes, nflops, coll_bytes = vsharded_work(B, K, V, mp, storage)
        passes = vsharded_passes(storage)
        bound = kernel_bound(nbytes, nflops, card, passes)
        per_rank = op_times[storage]["per_rank"]
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/fused_decoder.py",
            "replaces": "gfedntm_tpu/ops/fused_decoder.py:824",
            "launches": launches, "max_abs_err": worst[storage],
            "ms": min(per_rank[0]["kernel"]), "plain_ms": min(per_rank[0]["plain"]),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None,
        }
        notes[name] = (
            f"{storage} storage; per rank at B={B} K={K} V={V} mp={mp}, forward + backward, "
            f"backend {op_times[storage]['backend']}; ms per rank "
            f"{[r['kernel'] for r in per_rank]} plain_ms "
            f"{[r['plain'] for r in per_rank]}; bound {bound['bound_by']} "
            f"({bound['peaks']} peaks: {nbytes / 1e6:.1f} MB incl. {coll_bytes / 1e3:.1f} kB of "
            f"collectives -> {bound['bytes_ms']:.4f} ms, {nflops / 1e9:.2f} GFLOP as {passes:.3g} "
            f"TF32 products -> {bound['ops_ms']:.4f} ms); FP32 SIMT bound "
            f"{bound['simt_bound_ms']:.4f} ms; max |err| vs the full-V kernels, tol {ATOL:g} + "
            f"{RTOL:g}*max|plain|"
        )
    return X, kw, group


# ---------------------------------------------------------------------------
# Phase 5: validation, persistence and federated checkpoint/resume
# ---------------------------------------------------------------------------
#: Where phase 5 writes its checkpoints (inside the checkout; ``build/`` is
#: ignored by git). Emptied before and after the phase.
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"


def eval_kernel_work(b, k, v, storage="float32") -> dict:
    """K1 and K2 in eval mode: (bytes, FLOPs) as :func:`kernel_work` counts
    them. K1's eval branch has no column-statistics pass: it reads the
    running mean and variance and writes them out as its statistics, and
    computes z = theta beta for the softmax only. K2 is the training kernel."""
    f4, fs = 4.0, 2.0 if storage == "bfloat16" else 4.0
    return {
        "stats": (f4 * (b * k + b + 4 * v + 2 * b) + fs * k * v, 2.0 * b * k * v),
        "loss": kernel_work(b, k, v, storage)["loss"],
    }


def saved_epochs(val_losses: list, patience: int, delta: float) -> list[int]:
    """The epochs at which ``EarlyStopping`` saves, for these losses."""
    from gfedntm_tpu_torch.train.early_stopping import EarlyStopping

    saved, epoch = [], [0]
    stopper = EarlyStopping(patience, delta, checkpoint_fn=lambda: saved.append(epoch[0]))
    for epoch[0], value in enumerate(val_losses):
        stopper(value)
        if stopper.early_stop:
            break
    return saved


def eval_kernel_rows(card: str, rows: dict, notes: dict) -> None:
    """K1 and K2 in eval mode at one rank's shard of the sharded validation
    (B=256, K=50, V=50,000) against their plain versions, with masked rows,
    no masked row and all rows masked, then timed: plain, kernel, kernel,
    plain. Adds the ``stats_eval`` and ``loss_eval`` rows (launches: the
    sharded validation's, set by the caller)."""
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    b, k, v = 256, 50, 50_000
    worst = {"stats": 0.0, "loss": 0.0}
    for i, mask_kind in enumerate(("partial", "none", "all")):
        t = make_inputs(b, k, v, seed=300 + i, mask_kind=mask_kind)
        case = f"eval B={b} K={k} V={v} mask={mask_kind}"
        st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], False)
        ref = fd.stats_reference(*st_args)
        worst["stats"] = max(worst["stats"], compare("mean,var,m,s", fd.stats(*st_args), ref,
                                                     case))
        lo_args = (t["theta"], t["beta"], t["x"], *ref)
        worst["loss"] = max(worst["loss"], compare("loss,rd", fd.loss(*lo_args),
                                                   fd.loss_reference(*lo_args), case))
        print(f"eval kernels ok: {case}", flush=True)
    t = make_inputs(b, k, v, seed=300, mask_kind="partial")
    st_args = (t["theta"], t["beta"], t["mask"], t["run_mean"], t["run_var"], False)
    lo_args = (t["theta"], t["beta"], t["x"], *fd.stats_reference(*st_args))
    work = eval_kernel_work(b, k, v)
    for name, kernel_fn, plain_fn in (
            ("stats", lambda: fd.stats(*st_args), lambda: fd.stats_reference(*st_args)),
            ("loss", lambda: fd.loss(*lo_args), lambda: fd.loss_reference(*lo_args))):
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        nbytes, nflops = work[name]
        bound = kernel_bound(nbytes, nflops, card)
        rows[name + "_eval"] = {
            "name": name + "_eval", "route": "cuda",
            "source": "gfedntm_tpu_torch/ops/csrc/fused_decoder.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst[name],
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
        }
        notes[name + "_eval"] = (
            f"eval mode (the sharded validation's route, K5 training=False) at one rank's "
            f"shard B={b} K={k} V={v}; tol {ATOL:g} + {RTOL:g}*max|plain| per output; ms "
            f"{k1:.4f}/{k2:.4f} plain_ms {p1:.4f}/{p2:.4f}; bound {bound['bound_by']} "
            f"({bound['peaks']} peaks: {nbytes / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
            f"{nflops / 1e9:.2f} GFLOP as 3xTF32 -> {bound['ops_ms']:.4f} ms)")


def validation_fit_phase(datasets: list) -> None:
    """(a) ``AVITM.fit`` with validation and ``save_dir``; a fresh model's
    ``load`` of every saved epoch against the model as it was saved."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.data.datasets import make_epoch_schedule
    from gfedntm_tpu_torch.train.steps import eval_epoch, grad_step, take

    V, K, B = 100_000, 50, 256
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=3)
    train = datasets[0]
    val = BowDataset(X=datasets[1].X[:256], idx2token=datasets[1].idx2token)
    save_dir = SCRATCH / "avitm"
    model = AVITM(**kw)
    snapshots = {}
    save = model.save

    def save_and_snapshot(models_dir):
        save(models_dir)
        snapshots[model.nn_epoch] = {k: v.detach().clone()
                                     for k, v in model.model.state_dict().items()}

    model.save = save_and_snapshot
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(train, val, save_dir=str(save_dir), n_samples=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = model.validation_losses
    want = saved_epochs(losses, 5, 0.0)
    files = sorted(p.name for p in save_dir.iterdir())
    print(f"validation fit: {len(train)} training and {len(val)} validation documents, "
          f"{len(model.epoch_losses)} epochs in {secs:.3f} s; train losses {model.epoch_losses}; "
          f"validation losses {losses}; saved epochs {want}: {files}", flush=True)
    check(len(losses) == len(model.epoch_losses) == 3 and bool(np.isfinite(losses).all()),
          f"validation losses {losses}")
    check(files == sorted(f"epoch_{e}.{x}" for e in want for x in ("json", "npz")),
          f"saved files {files}, want epochs {want}")
    check(sorted(snapshots) == want, f"saves at epochs {sorted(snapshots)}, want {want}")

    rng = np.random.default_rng(0)
    x_val = model._device_data(val)
    vsched = make_epoch_schedule(len(val), B, rng)
    vidx = torch.as_tensor(vsched.indices, device=model.device, dtype=torch.long)
    vmask = torch.as_tensor(vsched.mask, device=model.device, dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(len(vidx), B, K)).astype(np.float32),
                            device=model.device)
    for epoch, state in snapshots.items():
        fresh, saved = AVITM(**kw), AVITM(**kw)
        fresh.load(str(save_dir), epoch)
        saved.model.load_state_dict(state)
        for key, value in state.items():
            check(torch.equal(fresh.model.state_dict()[key], value),
                  f"load(epoch {epoch}): {key} differs from the saved state")
        check(np.array_equal(fresh.get_topic_word_matrix(), saved.get_topic_word_matrix()),
              f"load(epoch {epoch}): topic-word matrix differs")
        losses_fresh, losses_saved = (eval_epoch(m.model, x_val, vidx, vmask, noise=noise)
                                      for m in (fresh, saved))
        check(torch.equal(losses_fresh, losses_saved),
              f"load(epoch {epoch}): eval loss {losses_fresh} != {losses_saved}")
    print(f"validation fit: load of epochs {sorted(snapshots)} bitwise equal to the saved "
          f"state, topic-word matrix and eval loss with injected noise "
          f"({float(losses_saved.sum()):.6f})", flush=True)

    x_train = model._device_data(train)
    sched = make_epoch_schedule(len(train), B, rng)
    idx = torch.as_tensor(sched.indices, device=model.device, dtype=torch.long)
    mask = torch.as_tensor(sched.mask, device=model.device, dtype=torch.float32)

    def train_epoch():
        for i in range(len(idx)):
            grad_step(model.model, model.optimizer, take(x_train, idx[i]), mask[i], True,
                      generator=model.generator)

    train_ms = time_ms(train_epoch, reps=5, warmup=1)
    val_ms = time_ms(lambda: eval_epoch(model.model, x_val, vidx, vmask,
                                        generator=model.generator), reps=5, warmup=1)
    print(f"validation fit: validation epoch ({len(vidx)} step of B={B}, unfused eval decode) "
          f"{val_ms:.3f} ms; training epoch ({len(idx)} steps) {train_ms:.3f} ms "
          f"({train_ms / len(idx):.3f} ms per step)", flush=True)


def resume_phase(datasets: list, result) -> None:
    """(b) federated checkpoint/resume, bitwise, in float32 and bf16, with
    the checkpoint's size and write/restore times; (c) the metrics run."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer
    from gfedntm_tpu_torch.train import checkpoint as ckpt
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    V, K, B, C = 100_000, 50, 256, 2

    def trainer(dtype):
        return FederatedTrainer(AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100),
                                      batch_size=B, num_epochs=2, compute_dtype=dtype),
                                n_clients=C)

    def same_run(a, b) -> list[str]:
        bad = [] if np.array_equal(a.losses, b.losses) else ["losses"]
        for c in range(C):
            for tree in ("client_params", "client_batch_stats"):
                bad += [f"client {c} {k}" for k, v in getattr(b, tree)[c].items()
                        if not torch.equal(getattr(a, tree)[c][k], v)]
        return bad

    class Interrupt(Exception):
        pass

    def interrupt_at_8(step, params, batch_stats):
        if step == 8:
            raise Interrupt

    times = {"save": [], "restore": []}
    originals = {name: getattr(ckpt.CheckpointManager, name) for name in times}

    def timed(name):
        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](self, *args, **kwargs)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for dtype in ("float32", "bfloat16"):
        root = SCRATCH / f"federated_{dtype}"
        logger = MetricsLogger(validate=True) if dtype == "float32" else None
        full = trainer(dtype).fit(datasets, checkpoint_dir=str(root / "full"),
                                  checkpoint_every=4, metrics=logger)
        if dtype == "float32":
            diff = same_run(full, result)
            check(not diff, f"the checkpointed run with metrics differs from the main path's "
                  f"plain run in {diff[:5]}")
        for name in times:
            setattr(ckpt.CheckpointManager, name, timed(name))
            times[name].clear()
        try:
            try:
                trainer(dtype).fit(datasets, checkpoint_dir=str(root / "run"),
                                   checkpoint_every=4, segment_callback=interrupt_at_8)
                check(False, "the segment callback did not interrupt the run")
            except Interrupt:
                pass
            manager = ckpt.CheckpointManager(str(root / "run"))
            check(manager.all_steps() == [4], f"checkpoints {manager.all_steps()}, want [4]")
            size = (root / "run" / "step_4.pt").stat().st_size
            resumed = trainer(dtype).fit(datasets, checkpoint_dir=str(root / "run"),
                                         checkpoint_every=4, resume=True)
        finally:
            for name, original in originals.items():
                setattr(ckpt.CheckpointManager, name, original)
        diff = same_run(resumed, full)
        print(f"federated resume {dtype}: interrupted by the segment callback at step 8, "
              f"resumed from step 4 in a fresh trainer; losses and every client's state "
              f"bitwise equal to the uninterrupted run: {not diff} {diff[:5]}; checkpoint "
              f"{size / 1e6:.1f} MB ({C} clients' networks and Adam state), write ms "
              f"{[round(t, 1) for t in times['save']]}, restore ms "
              f"{[round(t, 1) for t in times['restore']]}", flush=True)
        check(not diff, f"{dtype}: the resumed run differs from the uninterrupted one in "
              f"{diff[:5]}")
        if logger is not None:
            print(metrics_report(logger), flush=True)


def metrics_report(logger) -> str:
    """(c) The line on a two-segment federated run's metrics: every record
    valid, two ``federated_segment`` records, one step-time observation (the
    first segment holds the warm-up) and a positive ``docs_per_s``; fails
    otherwise."""
    from gfedntm_tpu_torch.utils.observability import validate_record

    for record in logger.records:
        validate_record(record)
    events = [r["event"] for r in logger.records]
    snap = logger.registry.snapshot()
    hist = snap.get("trainer_step_s", {"count": 0, "sum": 0.0})
    docs = snap.get("docs_per_s", {}).get("value")
    check(events.count("federated_segment") == 2 and hist["count"] == 1 and bool(docs),
          f"metrics records {events}, registry {sorted(snap)}")
    return (f"metrics: {len(events)} records, all valid ({', '.join(sorted(set(events)))}); "
            f"docs_per_s {docs:.1f} over the second segment (the first holds the warm-up); "
            f"trainer_step_s {hist['count']} observation, {hist['sum'] * 1e3:.3f} ms per step; "
            f"federated_mesh_devices {snap['federated_mesh_devices']['value']:g}")


def sharded_validation_phase(X, kw: dict, res: list) -> dict:
    """(d) ``fit_sharded`` with validation at dp=1 x mp=2, run in phase 4's
    rank group (``res``, per rank; its checkpoints in
    :data:`SHARDED_SAVE`): per-rank launch counts (eval-mode K1 and K2
    through K5, K3 untouched by the validation), each validation against
    the unsharded eval teacher-forced from the same state, generator state
    and schedule, the same early-stopping decisions on both ranks, and rank
    0's checkpoints against the gathered state. Returns rank 0's eval-mode
    launches."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM
    from gfedntm_tpu_torch.parallel import programs

    V, K, B, mp = kw["input_size"], kw["n_components"], kw["batch_size"], 2
    Xv = synthetic_bow(V, K, 256, 1)
    save_dir = SHARDED_SAVE
    n_epochs = res[0]["last_epoch"] + 1
    n_train, n_val = len(X) // B * n_epochs, len(Xv) // B * n_epochs
    print(f"sharded validation: dp=1 x mp={mp}, {len(X)} + {len(Xv)} docs; launches per rank "
          f"{[r['launches'] for r in res]}; eval-mode {[r['eval_launches'] for r in res]}; "
          f"validation losses {res[0]['validation_losses']}", flush=True)
    for rank, r in enumerate(res):
        got, ev = r["launches"], r["eval_launches"]
        check(got["grads"] == n_train, f"rank {rank}: K3 launched {got['grads']} times, want "
              f"{n_train} (the training steps alone)")
        for name in ("stats", "loss", "vsharded"):
            check(got[name] == n_train + n_val, f"rank {rank}: {name} launched {got[name]} "
                  f"times, want {n_train} training + {n_val} validation")
        check(ev["stats"] == ev["vsharded"] == n_val,
              f"rank {rank}: eval-mode launches {ev}, want {n_val} of K1 and of K5")
        check(r["validation_losses"] == res[0]["validation_losses"]
              and r["last_epoch"] == res[0]["last_epoch"],
              f"rank {rank} decided otherwise than rank 0")
        check(bool(np.isfinite(r["validation_losses"]).all()), "non-finite validation loss")
    errs = []
    for record in res[0]["validations"]:
        replay = programs.replay_validation(AVITM(**kw), Xv, record)
        errs.append(abs(replay - record["val_loss"]) / abs(replay))
    want = saved_epochs(res[0]["validation_losses"], 5, 0.0)
    files = sorted(p.name for p in save_dir.iterdir())
    check(files == sorted(f"epoch_{e}.{x}" for e in want for x in ("json", "npz")),
          f"rank 0 saved {files}, want epochs {want}")
    for epoch in want:
        model = AVITM(**kw)
        model.load(str(save_dir), epoch)
        gathered = res[0]["validations"][epoch]["state"]
        for key, value in model.model.state_dict().items():
            check(np.array_equal(value.cpu().numpy(), gathered[key]),
                  f"rank 0's epoch_{epoch}.npz: {key} differs from the gathered state")
    print(f"sharded validation: K5 eval vs the unsharded unfused eval teacher-forced from the "
          f"same state and noise, relative error per epoch {[f'{e:.2e}' for e in errs]} "
          f"(limit 1e-4); both ranks stopped after epoch {res[0]['last_epoch']}; rank 0 saved "
          f"epochs {want}, each loading into an unsharded AVITM equal to the gathered state",
          flush=True)
    check(max(errs) <= 1e-4, f"sharded validation loss differs by {max(errs):.3e}")
    return res[0]["eval_launches"]


def persistence_phase(card: str, rows: dict, notes: dict, datasets: list, result, X,
                      kw: dict, validation: list) -> None:
    """Phase 5, (a) to (d), and the eval-mode rows of the kernels line;
    ``validation``: (d)'s per-rank results from phase 4's rank group."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    try:
        validation_fit_phase(datasets)
        resume_phase(datasets, result)
        eval_launches = sharded_validation_phase(X, kw, validation)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
        shutil.rmtree(SHARDED_SAVE, ignore_errors=True)
    eval_kernel_rows(card, rows, notes)
    rows["stats_eval"]["launches"] = eval_launches["stats"]
    rows["loss_eval"]["launches"] = eval_launches["vsharded"]  # one K2 per eval K5 forward
    notes["vsharded"] += (f"; phase 5's sharded validation: {eval_launches['vsharded']} "
                          f"eval-mode forwards per rank")


# ---------------------------------------------------------------------------
# Phase 6: data-parallel training in spawned ranks
# ---------------------------------------------------------------------------
def beta_spread(beta, beta_ref, tol: float) -> tuple[float, float]:
    """Max |beta - beta_ref| and the fraction of entries beyond ``tol``."""
    import numpy as np

    diff = np.abs(beta - beta_ref)
    return float(diff.max()), float((diff > tol).mean())


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def first_step_errors(first, ref) -> tuple[float, float, float]:
    """(relative loss error, worst gradient error over its leaf's max|grad|,
    worst cancelling-leaf error over the largest gradient) of a sharded
    first step against the unsharded one."""
    import numpy as np

    (loss, grads), (ref_loss, ref_grads) = first, ref
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    rel = [float(np.abs(grads[n] - g).max()) / float(np.abs(g).max())
           for n, g in ref_grads.items() if n not in DEGENERATE]
    cancel = [float(np.abs(grads[n] - ref_grads[n]).max()) / scale for n in DEGENERATE]
    return abs(loss - ref_loss) / abs(ref_loss), max(rel), max(cancel)


def step_line(card: str, label: str, ranks: list, backend: str, devices: list, steps: int) -> str:
    return (f"data parallel steady step, {card}: {label} ({backend} on {devices}): "
            f"{[round(r['step_ms'], 3) for r in ranks]} ms per step per rank ({steps} warm "
            f"steps between barriers, batch gather included); bytes per step through each data "
            f"group's all_reduce: batch gather {ranks[0]['step_bytes']['batch_gather'] / 1e6:.1f}"
            f" MB, gradient sum {ranks[0]['step_bytes']['gradient_sum'] / 1e6:.1f} MB")


def data_parallel_setup():
    """Phase 6's corpus, fused and unfused settings, and steps."""
    V, K, B, N = 100_000, 50, 256, 2048
    kw = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
              num_epochs=1, dropout=0.2, seed=0)
    return synthetic_bow(V, K, N, 0), synthetic_bow(V, K, 256, 1), kw, \
        {**kw, "fused_decoder": False}, 8


def data_parallel_calls() -> dict:
    """Phase 6's rank programs for :func:`rank_groups`: (a) ``fit_sharded``
    at dp=2 x mp=2 with its validation, (b) ``fit_data_sharded`` at dp=2."""
    from gfedntm_tpu_torch.parallel import programs

    X, Xv, kw, kwu, steps = data_parallel_setup()
    return {
        "dp fit_sharded": (4, programs.fit, (2, 2, kw, shared(X), None, 1, steps, shared(Xv),
                                             None, 5, 0.0)),
        "dp fit_data_sharded": (2, programs.fit_data, (2, kwu, shared(X), None, 1, None, None,
                                                       5, 0.0, steps)),
    }


def data_parallel_phase(card: str, notes: dict, groups: dict | None = None) -> dict:
    """Phase 6: (a) ``fit_sharded`` at dp=2 x mp=2 with validation and (b)
    ``fit_data_sharded`` at dp=2, each against the unsharded fit on the
    card, with per-rank launch counts, steady ms per step and the bytes its
    data-group collectives move per step. Their rank programs ran in phase
    4's groups when ``groups`` holds them, else run here. Returns rank 0's
    result of (a)."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs

    t_phase = time.perf_counter()
    if groups is None:
        groups = rank_groups(data_parallel_calls())
    X, Xv, kw, kwu, steps = data_parallel_setup()
    (N, V), K, B, dp, mp = X.shape, kw["n_components"], kw["batch_size"], 2, 2

    # (a) fit_sharded at dp x mp, one epoch and its validation.
    backend, devices = groups[f"layout/{dp * mp}"]
    res = groups["dp fit_sharded"]
    n_val = len(Xv) // B
    print(f"data parallel (a): fit_sharded {backend}, dp={dp} x mp={mp} on {devices}, {N} + "
          f"{len(Xv)} docs, V={V}, dropout {kw['dropout']}; per rank, launches "
          f"{[nonzero(r['launches']) for r in res]}, eval-mode of them "
          f"{[nonzero(r['eval_launches']) for r in res]}, rows-sharded K5 calls "
          f"{[r['rows_calls']['vsharded_rows'] for r in res]}; step losses "
          f"{res[0]['step_losses']}", flush=True)
    print(step_line(card, f"fit_sharded dp={dp} x mp={mp}", res, backend, devices, steps),
          flush=True)
    for rank, r in enumerate(res):
        got, ev = r["launches"], r["eval_launches"]
        check(got["grads"] == 0, f"rank {rank}: K3 launched {got['grads']} times in dp > 1 "
              f"training, want 0 (K5's rows-sharded branch)")
        for name in ("stats", "loss", "vsharded"):
            check(got[name] == n_val, f"rank {rank}: {name} launched {got[name]} times, want "
                  f"{n_val} (the validation's eval forward)")
        check(ev["stats"] == ev["vsharded"] == n_val, f"rank {rank}: eval-mode launches {ev}")
        check(r["rows_calls"]["vsharded_rows"] == steps,
              f"rank {rank}: {r['rows_calls']} rows-sharded calls, want {steps}")
        check(len(r["step_losses"]) == steps and bool(np.isfinite(r["step_losses"]).all()),
              f"rank {rank}: step losses {r['step_losses']}")
        check(r["validation_losses"] == res[0]["validation_losses"],
              f"rank {rank}: validation losses differ from rank 0's")
    check_same_state(res, f"dp={dp} x mp={mp}")

    # The unsharded fits on the card, fused and unfused: the same seed,
    # schedule and draws. Their beta spread is what reduction order alone
    # gives after Adam (the witness for both parts).
    ref, unfused = AVITM(**kw), AVITM(**kwu)
    for model in (ref, unfused):
        model.fit(BowDataset(X=X), n_samples=1)
    beta_ref, beta_unfused = (m.model.beta.detach().cpu().numpy() for m in (ref, unfused))
    tol = 1e-3 * float(np.abs(beta_ref).max())
    witness = beta_spread(beta_unfused, beta_ref, tol)
    witness_1e4 = beta_spread(beta_unfused, beta_ref, 1e-4)[1]
    max_limit = max(4.0 * ref.lr, 1.5 * witness[0])

    def step_err(losses, model):
        want = np.asarray(model.step_losses)
        return float(np.max(np.abs(np.asarray(losses) - want) / np.abs(want)))

    loss_a, grad_a, cancel_a = first_step_errors(res[0]["first_step"],
                                                 programs.step_gradients(AVITM(**kw), X))
    steps_a = step_err(res[0]["step_losses"], ref)
    sharded = beta_spread(res[0]["state"]["beta"], beta_ref, tol)
    frac_limit = 1.5 * witness[1] + 1e-4
    errs = [abs(programs.replay_validation(AVITM(**kw), Xv, rec) - rec["val_loss"])
            / abs(rec["val_loss"]) for rec in res[0]["validations"]]
    print(f"data parallel (a) vs the unsharded fused fit: first-step loss {loss_a:.3e} "
          f"relative, gradients within {grad_a:.3e} of each leaf's max|grad| (limit 1e-3), "
          f"{', '.join(DEGENERATE)} within {cancel_a:.3e} of the largest (limit 1e-5); step "
          f"losses {steps_a:.3e} (limit 1e-3); beta max |diff| {sharded[0]:.3e}, "
          f"{sharded[1]:.6f} of entries beyond {tol:.3e}; the unfused witness {witness[0]:.3e}, "
          f"{witness[1]:.6f} (limits {max_limit:.3e}, {frac_limit:.6f}); validation vs the "
          f"teacher-forced unsharded eval {[f'{e:.2e}' for e in errs]} (limit 1e-4)", flush=True)
    check(loss_a <= 1e-3 and grad_a <= 1e-3 and cancel_a <= 1e-5,
          f"first step: loss {loss_a:.3e}, gradients {grad_a:.3e}, cancelling {cancel_a:.3e}")
    check(steps_a <= 1e-3, f"step losses differ from the unsharded fit by {steps_a:.3e}")
    check(sharded[0] <= max_limit, f"beta max |diff| {sharded[0]:.3e} > {max_limit:.3e}")
    check(sharded[1] <= frac_limit, f"beta: {sharded[1]:.6f} of entries beyond {tol:.3e}")
    check(max(errs) <= 1e-4, f"validation loss differs by {max(errs):.3e}")

    # (b) fit_data_sharded at dp, unfused, one epoch.
    backend_b, devices_b = groups[f"layout/{dp}"]
    resd = groups["dp fit_data_sharded"]
    print(f"data parallel (b): fit_data_sharded {backend_b}, dp={dp} on {devices_b}; summary "
          f"{resd[0]['summary']}", flush=True)
    print(step_line(card, f"fit_data_sharded dp={dp}", resd, backend_b, devices_b, steps),
          flush=True)
    from gfedntm_tpu_torch.utils import flops

    summary = resd[0]["summary"]
    want = model_step_flops(B, V, K, (100, 100))
    peak, source = flops.resolve_peak_flops_per_device("cuda:0")
    step_mfu = flops.mfu(summary["flops_per_step"], resd[0]["step_ms"] / 1e3, dp, peak)
    print(f"data parallel (b) FLOPs, {card}: flops_per_step {summary['flops_per_step']:.0f} "
          f"(analytic {want}), flops_per_epoch {summary['flops_per_epoch']:.0f}, summary mfu "
          f"{summary['mfu']} (one epoch: no steady epoch), mfu of the steady step "
          f"{step_mfu:.6f} per rank of {peak:.4g} FLOP/s ({summary['peak_flops_source']})",
          flush=True)
    check(summary["flops_per_step"] == want,
          f"fit_data_sharded flops_per_step {summary['flops_per_step']} != {want}")
    check(summary["peak_flops_source"] == source,
          f"peak source {summary['peak_flops_source']} on the ranks, {source} here")
    for rank, r in enumerate(resd):
        for key, val in r["state"].items():
            check(np.array_equal(val, resd[0]["state"][key]),
                  f"fit_data_sharded: {key} differs between rank 0 and rank {rank}")
    loss_b, grad_b, cancel_b = first_step_errors(resd[0]["first_step"],
                                                 programs.step_gradients(AVITM(**kwu), X))
    steps_b = step_err(resd[0]["step_losses"], unfused)
    data_b = beta_spread(resd[0]["state"]["beta"], beta_unfused, 1e-4)
    frac_b = 1.5 * witness_1e4 + 1e-4
    # beta within 1e-4 of the unsharded unfused fit, but for the entries
    # that reduction order alone moves by up to a few lr after Adam: no more
    # of them than the witness has beyond 1e-4 (times 1.5), and none
    # further than the witness's largest (times 1.5, or 4 lr).
    print(f"data parallel (b) vs the unsharded unfused fit: first-step loss {loss_b:.3e} "
          f"relative, gradients within {grad_b:.3e} of each leaf's max|grad| (limit 1e-3), "
          f"{', '.join(DEGENERATE)} within {cancel_b:.3e} (limit 1e-5); step losses "
          f"{steps_b:.3e} relative (limit 1e-4); beta max |diff| {data_b[0]:.3e}, "
          f"{data_b[1]:.6f} of entries beyond 1e-4; the witness (fused vs unfused unsharded) "
          f"{witness[0]:.3e}, {witness_1e4:.6f} beyond 1e-4 (limits {max_limit:.3e}, "
          f"{frac_b:.6f})", flush=True)
    check(loss_b <= 1e-3 and grad_b <= 1e-3 and cancel_b <= 1e-5,
          f"fit_data_sharded first step: loss {loss_b:.3e}, gradients {grad_b:.3e}, "
          f"cancelling {cancel_b:.3e}")
    check(steps_b <= 1e-4, f"fit_data_sharded step losses differ by {steps_b:.3e}")
    check(data_b[0] <= max_limit, f"fit_data_sharded beta max |diff| {data_b[0]:.3e}")
    check(data_b[1] <= frac_b, f"fit_data_sharded beta: {data_b[1]:.6f} of entries beyond "
          f"1e-4, limit {frac_b:.6f}")

    seconds = time.perf_counter() - t_phase
    print(f"data parallel: phase 6 took {seconds:.1f} s ({card})", flush=True)
    notes["vsharded"] += (f"; phase 6 (dp={dp} x mp={mp}): {res[0]['rows_calls']['vsharded_rows']}"
                          f" rows-sharded training calls (plain tensor ops, no kernel) and "
                          f"{res[0]['eval_launches']['vsharded']} eval-mode forward(s) per rank")
    return res[0]


# ---------------------------------------------------------------------------
# Phase 7: the unfused and LDA decodes at mp > 1; the raw-text flow
# ---------------------------------------------------------------------------
DECODE_CASES = (("prodLDA", 1, 2), ("LDA", 1, 2), ("LDA", 2, 2))


def decode_setup():
    """Phase 7(a)'s corpus, settings (but the model type) and steps."""
    V, K, B, N = 100_000, 50, 256, 2048
    base = dict(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                num_epochs=1, dropout=0.0, seed=0, fused_decoder=False)
    return synthetic_bow(V, K, N, 0), synthetic_bow(V, K, 256, 1), base, 8


def decode_calls() -> dict:
    """Phase 7(a)'s rank programs for :func:`rank_groups`, one
    ``fit_sharded`` per :data:`DECODE_CASES` entry."""
    from gfedntm_tpu_torch.parallel import programs

    X, Xv, base, steps = decode_setup()
    return {f"decode {mt} {dp}x{mp}": (dp * mp, programs.fit, (
        dp, mp, {**base, "model_type": mt}, shared(X), None, 1, steps, shared(Xv), None, 5, 0.0))
        for mt, dp, mp in DECODE_CASES}


def sharded_decodes_phase(card: str, groups: dict | None = None) -> None:
    """Phase 7(a): ``fit_sharded`` of the unfused prodLDA and the LDA decodes
    at mp > 1 (:data:`DECODE_CASES`), each against the unsharded unfused fit
    of its model type on the card. The rank programs ran in phase 4's
    groups when ``groups`` holds them, else run here."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.parallel import programs

    if groups is None:
        groups = rank_groups(decode_calls())
    X, Xv, base, steps = decode_setup()
    results = {}
    for mt, dp, mp in DECODE_CASES:
        backend, devices = groups[f"layout/{dp * mp}"]
        ranks = groups[f"decode {mt} {dp}x{mp}"]
        # Where rank 0's seconds went in its program.
        print(f"sharded decodes: {mt} at dp={dp} x mp={mp}, {backend} on {devices}: rank 0's "
              + ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["seconds"].items()), flush=True)
        results[mt, dp, mp] = (ranks, backend, devices)

    for model_type in dict.fromkeys(mt for mt, _, _ in DECODE_CASES):
        t0 = time.perf_counter()
        kw = {**base, "model_type": model_type}
        # The unsharded fit on the card, and a witness of what reduction
        # order alone does to beta after Adam: the same fit with the encoder
        # input layer summed over its two column blocks.
        ref, split = AVITM(**kw), AVITM(**kw)
        split_input_layer(split, 2)
        for model in (ref, split):
            model.fit(BowDataset(X=X), n_samples=1)
        ref_step = programs.step_gradients(AVITM(**kw), X)
        split_step = AVITM(**kw)
        split_input_layer(split_step, 2)
        # The cancelling leaves are rounding noise on both sides: held to
        # 1e-5 of the largest gradient, or to twice the witness's own noise.
        cancel_limit = max(1e-5, 2.0 * first_step_errors(
            programs.step_gradients(split_step, X), ref_step)[2])
        beta_ref = ref.model.beta.detach().cpu().numpy()
        witness = beta_spread(split.model.beta.detach().cpu().numpy(), beta_ref, 1e-4)
        max_limit = max(4.0 * ref.lr, 1.5 * witness[0])
        frac_limit = 1.5 * witness[1] + 1e-4
        want = np.asarray(ref.step_losses)
        print(f"sharded decodes: the unsharded {model_type} fit, its split-encoder witness "
              f"and their first steps took {time.perf_counter() - t0:.1f} s", flush=True)
        for (mt, dp, mp), (res, backend, devices) in results.items():
            if mt != model_type:
                continue
            label = f"{mt} dp={dp} x mp={mp}"
            r0 = res[0]
            loss_e, grad_e, cancel_e = first_step_errors(r0["first_step"], ref_step)
            steps_e = float(np.max(np.abs(np.asarray(r0["step_losses"]) - want) / np.abs(want)))
            beta = beta_spread(r0["state"]["beta"], beta_ref, 1e-4)
            val_e = [abs(programs.replay_validation(AVITM(**kw), Xv, rec) - rec["val_loss"])
                     / abs(rec["val_loss"]) for rec in r0["validations"]]
            launches = [{**r["launches"], **{f"eval_{k}": v for k, v in
                                             r["eval_launches"].items()},
                         **r["rows_calls"]} for r in res]
            print(f"sharded decodes, {label}: launches per rank (K1 stats, K2 loss, K3 grads, "
                  f"K5 vsharded, their bf16 and eval counts, K5 rows-sharded calls) "
                  f"{[nonzero(c) or 'all 0' for c in launches]}; step losses "
                  f"{r0['step_losses']}; validation {r0['validation_losses']}", flush=True)
            print(f"sharded decodes, {label} vs the unsharded {mt} fit: first-step loss "
                  f"{loss_e:.3e} relative, gradients within {grad_e:.3e} of each leaf's "
                  f"max|grad| (limit 1e-3), {', '.join(DEGENERATE)} within {cancel_e:.3e} of the "
                  f"largest (limit {cancel_limit:.3e}: 1e-5 or twice the split-encoder witness's "
                  f"first step); step losses {steps_e:.3e} (limit 1e-4); beta max "
                  f"|diff| {beta[0]:.3e}, {beta[1]:.6f} of entries beyond 1e-4; the "
                  f"split-encoder witness {witness[0]:.3e}, {witness[1]:.6f} (limits "
                  f"{max_limit:.3e}, {frac_limit:.6f}); validation vs the teacher-forced "
                  f"unsharded eval {[f'{e:.2e}' for e in val_e]} (limit 1e-4)", flush=True)
            print(f"sharded decodes steady step, {card}: {label} ({backend} on {devices}): "
                  f"{[round(r['step_ms'], 3) for r in res]} ms per step per rank ({steps} warm "
                  f"steps between barriers)", flush=True)
            for rank, (r, counts) in enumerate(zip(res, launches)):
                check(set(counts.values()) == {0},
                      f"{label}: rank {rank} launched or called a kernel: {nonzero(counts)}")
                check(len(r["step_losses"]) == steps
                      and bool(np.isfinite(r["step_losses"]).all())
                      and bool(np.isfinite(r["validation_losses"]).all()),
                      f"{label}: rank {rank} step losses {r['step_losses']}, validation "
                      f"{r['validation_losses']}")
                check(r["validation_losses"] == r0["validation_losses"],
                      f"{label}: rank {rank}'s validation losses differ from rank 0's")
            check_same_state(res, label)
            check(loss_e <= 1e-3 and grad_e <= 1e-3 and cancel_e <= cancel_limit,
                  f"{label} first step: loss {loss_e:.3e}, gradients {grad_e:.3e}, "
                  f"cancelling {cancel_e:.3e}")
            check(steps_e <= 1e-4, f"{label}: step losses differ by {steps_e:.3e}")
            check(beta[0] <= max_limit, f"{label}: beta max |diff| {beta[0]:.3e}")
            check(beta[1] <= frac_limit, f"{label}: beta: {beta[1]:.6f} of entries beyond "
                  f"1e-4, limit {frac_limit:.6f}")
            check(len(val_e) == 1 and max(val_e) <= 1e-4,
                  f"{label}: validation differs from the teacher-forced eval by {val_e}")


def raw_text_corpora(card: str):
    """Phase 7(b)'s clients from raw text: ``generate_synthetic_corpus``'s
    token-string documents as ``RawCorpus`` clients, through
    ``run_vocab_consensus`` (checked: V = 66,001, each client's BoW the
    synthetic BoW's columns, ``vectorize`` equal). Returns ``(clients,
    consensus)``."""
    import numpy as np

    from gfedntm_tpu_torch import (
        RawCorpus,
        generate_synthetic_corpus,
        native,
        run_vocab_consensus,
    )
    from gfedntm_tpu_torch.data.vocab import vectorize

    V_FULL, K, C = 100_000, 50, 2
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(vocab_size=V_FULL, n_topics=K, n_docs=1024, n_nodes=C,
                                       materialize_docs=True, seed=0)
    clients = [RawCorpus(documents=node.documents) for node in corpus.nodes]
    n_tokens = sum(len(d.split()) for c in clients for d in c.documents)
    print(f"raw text: {C} clients x {len(clients[0])} documents, {n_tokens} tokens, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    check(native.available(), "the native BoW library did not build")
    t0 = time.perf_counter()
    consensus = run_vocab_consensus(clients, max_features=None)
    consensus_s = time.perf_counter() - t0
    vocab = consensus.global_vocab
    V = len(vocab)
    t0 = time.perf_counter()
    again = [vectorize(c.documents, vocab) for c in clients]
    vectorize_s = time.perf_counter() - t0
    cols = np.array([int(t[2:]) for t in vocab.tokens])
    print(f"raw text, {card}: run_vocab_consensus(max_features=None) {consensus_s:.3f} s "
          f"(local vocabularies {[len(v) for v in consensus.local_vocabs]}, global V={V}); "
          f"vectorizing both clients against the global vocabulary {vectorize_s:.3f} s",
          flush=True)
    check(V == 66_001, f"global vocabulary of {V} words, want 66,001")
    for c, (node, ds) in enumerate(zip(corpus.nodes, consensus.datasets)):
        check(np.array_equal(ds.X, node.bow[:, cols]),
              f"client {c}: BoW differs from the synthetic BoW's columns")
        check(np.array_equal(again[c], ds.X), f"client {c}: vectorize differs from consensus")
    return clients, consensus


def raw_text_phase(card: str, notes: dict):
    """Phase 7(b): the user flow from raw text through the port: vocabulary
    consensus with the native BoW library, the federated fit through
    K1-K3, the global model's topics and their metrics. Returns
    :func:`raw_text_corpora`'s clients and consensus."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import AVITM, FederatedTrainer, npmi_coherence, topic_diversity
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    K, B, C = 50, 256, 2
    clients, consensus = raw_text_corpora(card)
    V = len(consensus.global_vocab)

    def run(num_epochs):
        template = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                         num_epochs=num_epochs)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(consensus.datasets)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    # K1-K3 on this flow's own shapes and data against their plain versions
    # (V % 4 = 1: the 4-byte cp.async ring): the first client's first B
    # documents, theta from an initial model's encoder on them, its beta and
    # BatchNorm statistics. Phase 2 holds the same shape on random inputs.
    net = AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B)
    x = torch.as_tensor(consensus.datasets[0].X[:B], device="cuda")
    mask = torch.ones(B, device="cuda")
    with torch.no_grad():
        theta = net.model.encode_theta(x, mask=mask, generator=net.generator).theta
    bn = net.model.beta_batchnorm
    case = f"the raw-text flow's first batch, B={B} K={K} V={V}"
    st_args = (theta, net.model.beta.detach(), mask, bn.running_mean, bn.running_var, True)
    mean, var, m, s = fd.stats_reference(*st_args)
    lo_args = (theta, net.model.beta.detach(), x, mean, var, m, s)
    ref_loss = fd.loss_reference(*lo_args)
    gr_args = lo_args + (ref_loss[1], mask / B, mask, True)
    errs = [compare("mean,var,m,s", fd.stats(*st_args), (mean, var, m, s), case),
            compare("loss,rd", fd.loss(*lo_args), ref_loss, case),
            compare("g_theta,g_beta", fd.grads(*gr_args), fd.grads_reference(*gr_args), case)]
    route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K)]
    print(f"raw text: K1, K2, K3 on {case} ({route}) within "
          f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions (tol {ATOL:g} + "
          f"{RTOL:g}*max|plain| per output)", flush=True)

    fd.reset_launches()
    trainer, result, secs = run(2)
    launches = dict(fd.LAUNCHES)
    print(f"raw text: fit {result.losses.shape[0]} global steps x {C} clients at V={V} in "
          f"{secs:.3f} s; launches {nonzero(launches)}; epoch losses {result.epoch_losses}",
          flush=True)
    check(result.losses.shape == (8, C), f"losses shape {result.losses.shape} != (8, {C})")
    check(bool(np.isfinite(result.losses).all()), "non-finite federated losses")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == 16, f"raw text: {name} launched {launches[name]} times, "
              f"want 16")
        notes[name] += (f"; phase 7 raw-text flow (V={V}, {4 if V % 4 else 16}-byte cp.async "
                        f"ring): {launches[name]} launches")
    model = trainer.make_global_model(result, consensus.datasets[0])
    topics = model.get_topics(10)
    check(len(topics) == K and all(len(t) == 10 and t[0].startswith("wd") for t in topics),
          "get_topics did not return 50 lists of 10 words")
    t0 = time.perf_counter()
    tokens = [d.split() for c in clients for d in c.documents]
    npmi = npmi_coherence(topics, tokens)
    diversity = topic_diversity(topics)
    print(f"raw text: topic 0 {topics[0]}; NPMI {npmi:.4f}, topic diversity {diversity:.4f} "
          f"over {len(tokens)} documents in {time.perf_counter() - t0:.2f} s", flush=True)
    check(np.isfinite(npmi) and -1.0 <= npmi <= 1.0, f"NPMI {npmi}")
    check(np.isfinite(diversity) and 0.0 <= diversity <= 1.0, f"topic diversity {diversity}")

    # Steady state as in phase 3: a 24-step fit minus an 8-step fit.
    run(2)
    secs8 = min(run(2)[2], run(2)[2])
    secs24 = min(run(6)[2], run(6)[2])
    ms_step = (secs24 - secs8) / 16 * 1e3
    check(ms_step > 0, f"steady-state step time {ms_step:.3f} ms is not positive")
    print(f"raw text steady step, {card}: {ms_step:.3f} ms per global step, "
          f"{C * B / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}, V={V}); warm 8-step fit "
          f"{secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms", flush=True)
    return clients, consensus


def decodes_and_text_phase(card: str, notes: dict, groups: dict | None = None):
    """Phase 7: (a) then (b), timed; (b) adds its launches to the K1-K3
    rows' ``notes``. Returns (b)'s clients and consensus."""
    t_phase = time.perf_counter()
    sharded_decodes_phase(card, groups)
    raw = raw_text_phase(card, notes)
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return raw


# ---------------------------------------------------------------------------
# Phase 8: the CTM family and the externally-stepped clients
# ---------------------------------------------------------------------------
CTM_LABELS = 5  # one-hot label classes of the CTM phases
CTM_CONTEXT = 768  # contextual embedding width (SBERT's)


def onehot_labels(n: int, seed: int):
    """``n`` seeded one-hot labels over :data:`CTM_LABELS` classes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.eye(CTM_LABELS, dtype=np.float32)[rng.integers(0, CTM_LABELS, n)]


def ctm_federated_phase(card: str, notes: dict, raw) -> list:
    """Phase 8 (a) and (b): federated CombinedTM with labels, float32 and
    bf16, and federated ZeroShotTM without labels, on phase 7(b)'s raw-text
    clients with ``hashing_embedder`` embeddings. Returns (a)'s datasets."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import (
        CombinedTM,
        CTMDataset,
        FederatedTrainer,
        ZeroShotTM,
        hashing_embedder,
        npmi_coherence,
        topic_diversity,
    )
    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    clients, consensus = raw
    V, K, B, C = len(consensus.global_vocab), 50, 256, 2
    t0 = time.perf_counter()
    embed = hashing_embedder(CTM_CONTEXT)
    contexts = [embed(c.documents) for c in clients]
    print(f"ctm: hashing_embedder({CTM_CONTEXT}) of {C} x {len(clients[0])} documents in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    datasets = [CTMDataset(X=ds.X, X_ctx=contexts[c], labels=onehot_labels(len(ds), c),
                           idx2token=ds.idx2token) for c, ds in enumerate(consensus.datasets)]
    kw = dict(input_size=V, contextual_size=CTM_CONTEXT, n_components=K,
              hidden_sizes=(100, 100), batch_size=B)

    def run(num_epochs, dtype="float32", cls=CombinedTM, data=datasets,
            label_size=CTM_LABELS):
        template = cls(**kw, num_epochs=num_epochs, label_size=label_size,
                       compute_dtype=dtype)
        trainer = FederatedTrainer(template, n_clients=C)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = trainer.fit(data)
        torch.cuda.synchronize()
        return trainer, result, time.perf_counter() - start

    # K1-K3 on this path's first batch against their plain versions, in
    # float32 and in bf16: theta from an initial CombinedTM's encoder on the
    # first client's first B documents, their embeddings and labels. The
    # bf16 kernels read beta and x rounded to bf16 at the padded pitch (7
    # pad columns at V=66,001), as the fit stores them; their plain versions
    # take the float32 values of the same rounded arrays.
    for dtype in ("float32", "bfloat16"):
        net = CombinedTM(**kw, label_size=CTM_LABELS, compute_dtype=dtype)
        first = {key: value[:B] for key, value in net._device_data(datasets[0]).items()}
        x, mask = first["x_bow"], torch.ones(B, device=net.device)
        with torch.no_grad():
            theta = net.model.encode_theta(x, first["x_ctx"], first["labels"], mask=mask,
                                           generator=net.generator).theta.float()
        beta_s, x_s = fd.store(net.model.beta.detach(), dtype), fd.store(x, dtype)
        beta_r, x_r = beta_s.float(), x_s.float()
        bn = net.model.beta_batchnorm
        case = f"the CombinedTM flow's first batch, {dtype}, B={B} K={K} V={V}"
        rest = (mask, bn.running_mean, bn.running_var, True)
        mean, var, m, s = fd.stats_reference(theta, beta_r, *rest)
        ref_loss = fd.loss_reference(theta, beta_r, x_r, mean, var, m, s)
        gr_rest = (mean, var, m, s, ref_loss[1], mask / B, mask, True)
        errs = [compare("mean,var,m,s", fd.stats(theta, beta_s, *rest, storage_dtype=dtype),
                        (mean, var, m, s), case),
                compare("loss,rd", fd.loss(theta, beta_s, x_s, mean, var, m, s,
                                           storage_dtype=dtype), ref_loss, case),
                compare("g_theta,g_beta", fd.grads(theta, beta_s, x_s, *gr_rest,
                                                   storage_dtype=dtype),
                        fd.grads_reference(theta, beta_r, x_r, *gr_rest), case)]
        route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K, dtype)]
        print(f"ctm: K1, K2, K3 on {case} ({route}) within "
              f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions (tol {ATOL:g} + "
              f"{RTOL:g}*max|plain| per output)", flush=True)

    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        fd.reset_launches()
        trainer, result, secs = run(2, dtype)
        launches = dict(fd.LAUNCHES)
        print(f"ctm (a) CombinedTM + labels, {dtype}: fit {result.losses.shape[0]} global "
              f"steps x {C} clients at V={V} in {secs:.3f} s; launches {nonzero(launches)}; "
              f"epoch losses {result.epoch_losses}", flush=True)
        check(result.losses.shape == (8, C), f"ctm {dtype}: losses shape {result.losses.shape}")
        check(bool(np.isfinite(result.losses).all()), f"ctm {dtype}: non-finite losses")
        for name in ("stats", "loss", "grads"):
            got = launches[name + suffix]
            check(got == 16 and sum(launches.values()) == 48,
                  f"ctm {dtype}: {name + suffix} launched {got} times (want 16), all "
                  f"{launches}")
            notes[name + suffix] += f"; phase 8(a) CombinedTM {dtype}: {got} launches"
        for tree in (result.client_params, result.client_batch_stats):
            for key, val in tree[0].items():
                check(val.dtype in (torch.float32, torch.long),
                      f"ctm {dtype}: {key} is {val.dtype}")
                for other in tree[1:]:
                    check(torch.equal(val, other[key]), f"ctm {dtype}: {key} differs across "
                          "clients")
        if dtype == "float32":
            model = trainer.make_global_model(result, datasets[0])
            check(isinstance(model, CombinedTM), f"global model is a {type(model).__name__}")
            topics = model.get_topics(10)
            check(len(topics) == K and all(len(t) == 10 for t in topics),
                  "get_topics did not return 50 lists of 10")
            tokens = [d.split() for c in clients for d in c.documents]
            npmi, diversity = npmi_coherence(topics, tokens), topic_diversity(topics)
            print(f"ctm (a): topic 0 {topics[0]}; NPMI {npmi:.4f}, topic diversity "
                  f"{diversity:.4f}", flush=True)
            check(np.isfinite(npmi) and -1.0 <= npmi <= 1.0, f"NPMI {npmi}")
            check(np.isfinite(diversity) and 0.0 <= diversity <= 1.0, f"diversity {diversity}")
            save_dir = SCRATCH / "ctm"
            model.nn_epoch = 1
            t0 = time.perf_counter()
            model.save(str(save_dir))
            fresh = CombinedTM(**kw, label_size=CTM_LABELS)
            fresh.load(str(save_dir), 1)
            for key, val in model.model.state_dict().items():
                check(torch.equal(fresh.model.state_dict()[key], val),
                      f"CombinedTM load: {key} differs from the saved state")
            print(f"ctm (a): save + load of the global CombinedTM bitwise equal "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
            shutil.rmtree(save_dir, ignore_errors=True)
        # Steady state as in phase 3: a 24-step fit minus an 8-step fit.
        secs8 = min(run(2, dtype)[2], run(2, dtype)[2])
        secs24 = min(run(6, dtype)[2], run(6, dtype)[2])
        ms_step = (secs24 - secs8) / 16 * 1e3
        check(ms_step > 0, f"ctm steady step time {ms_step:.3f} ms is not positive")
        print(f"ctm (a) steady step, {card}: CombinedTM + labels {dtype}: {ms_step:.3f} ms per "
              f"global step, {C * B / ms_step * 1e3:.1f} docs/s ({C} clients x B={B}, V={V}); "
              f"8-step fit {secs8 * 1e3:.1f} ms, 24-step fit {secs24 * 1e3:.1f} ms", flush=True)

    plain = [CTMDataset(X=d.X, X_ctx=d.X_ctx, idx2token=d.idx2token) for d in datasets]
    fd.reset_launches()
    _, result, secs = run(2, cls=ZeroShotTM, data=plain, label_size=0)
    launches = dict(fd.LAUNCHES)
    print(f"ctm (b) ZeroShotTM, no labels: fit {result.losses.shape[0]} global steps x {C} "
          f"clients in {secs:.3f} s; launches {nonzero(launches)}; epoch losses "
          f"{result.epoch_losses}", flush=True)
    check(bool(np.isfinite(result.losses).all()), "ZeroShotTM: non-finite losses")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == 16, f"ZeroShotTM: {name} launched {launches[name]} times")
        notes[name] += f"; phase 8(b) ZeroShotTM: {launches[name]} launches"
    for c, losses in enumerate(result.epoch_losses):
        check(losses[1] < losses[0],
              f"ZeroShotTM client {c}: epoch losses {losses} do not fall")
    return datasets


@functools.cache
def ctm_sharded_setup():
    """Phase 8(c)'s corpus (phase 4's BoW, seeded normal embeddings, one-hot
    labels) and settings, made once per script run."""
    import numpy as np

    V, K, B, N = 100_000, 50, 256, 2048
    X = synthetic_bow(V, K, N, 0)
    X_ctx = np.random.default_rng(1).standard_normal((N, CTM_CONTEXT), dtype=np.float32)
    labels = onehot_labels(N, 2)
    kw = dict(input_size=X.shape[1], contextual_size=CTM_CONTEXT, n_components=K,
              hidden_sizes=(100, 100), batch_size=B, num_epochs=1, dropout=0.0, seed=0,
              inference_type="combined", label_size=CTM_LABELS)
    return X, X_ctx, labels, kw


def ctm_sharded_calls() -> dict:
    """Phase 8(c)'s rank programs for :func:`rank_groups`: ``fit_sharded``
    of CombinedTM with labels at dp=1 x mp=2 and dp=2 x mp=2."""
    from gfedntm_tpu_torch.parallel import programs

    X, X_ctx, labels, kw = ctm_sharded_setup()
    corpus = {"X": shared(X), "X_ctx": shared(X_ctx), "labels": shared(labels)}
    return {f"ctm {dp}x{mp}": (dp * mp, programs.fit, (dp, mp, kw, corpus, None, 1, 4))
            for dp, mp in ((1, 2), (2, 2))}


def ctm_sharded_phase(card: str, groups: dict | None = None) -> None:
    """Phase 8 (c): ``fit_sharded`` of CombinedTM with labels on phase 4's
    corpus at dp=1 x mp=2 and dp=2 x mp=2 against the unsharded fit. The
    rank programs ran in phase 4's groups when ``groups`` holds them, else
    run here."""
    import numpy as np

    from gfedntm_tpu_torch import CTM, CTMDataset
    from gfedntm_tpu_torch.parallel import programs

    if groups is None:
        groups = rank_groups(ctm_sharded_calls())
    X, X_ctx, labels, kw = ctm_sharded_setup()
    ref = CTM(**kw)
    ref_step = programs.step_gradients(CTM(**kw), {"X": X, "X_ctx": X_ctx, "labels": labels})
    ref.fit(CTMDataset(X=X, X_ctx=X_ctx, labels=labels), n_samples=1)
    steps_ref = np.asarray(ref.step_losses)
    for dp, mp in ((1, 2), (2, 2)):
        backend, devices = groups[f"layout/{dp * mp}"]
        res = groups[f"ctm {dp}x{mp}"]
        # Where rank 0's seconds went in its program, as in phase 7(a).
        print(f"ctm (c) dp={dp} x mp={mp}: rank 0's "
              + ", ".join(f"{k} {v:.1f} s" for k, v in res[0]["seconds"].items()), flush=True)
        steps = len(steps_ref)
        for rank, r in enumerate(res):
            got = nonzero(r["launches"])
            want = ({"stats": steps, "loss": steps, "grads": steps, "vsharded": steps}
                    if dp == 1 else {})
            check(got == want, f"ctm {dp} x {mp} rank {rank}: launches {got}, want {want}")
            rows = r["rows_calls"]["vsharded_rows"]
            check(rows == (steps if dp > 1 else 0),
                  f"ctm {dp} x {mp} rank {rank}: {rows} rows-sharded K5 calls")
        check_same_state(res, f"ctm {dp} x {mp}")
        loss_e, grad_e, cancel_e = first_step_errors(res[0]["first_step"], ref_step)
        step_e = float(np.max(np.abs(np.asarray(res[0]["step_losses"]) - steps_ref)
                              / np.abs(steps_ref)))
        print(f"ctm (c) fit_sharded CombinedTM + labels, {backend} dp={dp} x mp={mp} on "
              f"{devices}: launches per rank "
              f"{[nonzero(r['launches']) for r in res]}, rows-sharded K5 calls "
              f"{[r['rows_calls']['vsharded_rows'] for r in res]}; first step: loss "
              f"{loss_e:.3e} relative, gradients within {grad_e:.3e} of each leaf's max|grad| "
              f"(limit 1e-3), {', '.join(DEGENERATE)} within {cancel_e:.3e} of the largest "
              f"(limit 1e-5); step losses {step_e:.3e} (limit 1e-3); state bitwise equal on "
              f"{dp * mp} ranks", flush=True)
        print(f"ctm (c) steady step, {card}: dp={dp} x mp={mp} ({backend}): "
              f"{[round(r['step_ms'], 3) for r in res]} ms per step per rank (4 warm steps "
              f"between barriers); bytes per step through each data group's all_reduce: batch "
              f"gather {res[0]['step_bytes']['batch_gather'] / 1e6:.1f} MB, gradient sum "
              f"{res[0]['step_bytes']['gradient_sum'] / 1e6:.1f} MB", flush=True)
        check(loss_e <= 1e-3 and grad_e <= 1e-3 and cancel_e <= 1e-5,
              f"ctm {dp} x {mp} first step: {loss_e:.3e}, {grad_e:.3e}, {cancel_e:.3e}")
        check(step_e <= 1e-3, f"ctm {dp} x {mp} step losses differ by {step_e:.3e}")


def stepper_phase(card: str, ctm_datasets: list, avitm_datasets: list) -> None:
    """Phase 8 (d): two ``FederatedCTM`` steppers on (a)'s model and data,
    then two ``FederatedAVITM`` steppers on phase 3's, each driven in
    process for 8 exchanged steps through ``weighted_mean``."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import (
        AVITM,
        CombinedTM,
        FederatedAVITM,
        FederatedCTM,
        weighted_mean,
    )
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    K, B = 50, 256
    ctm_kw = dict(input_size=ctm_datasets[0].vocab_size, contextual_size=CTM_CONTEXT,
                  n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2,
                  label_size=CTM_LABELS)
    avitm_kw = dict(input_size=avitm_datasets[0].vocab_size, n_components=K,
                    hidden_sizes=(100, 100), batch_size=B, num_epochs=2)
    for label, build, datasets in (
            ("FederatedCTM (CombinedTM + labels)",
             lambda c: FederatedCTM(CombinedTM(**ctm_kw, seed=c)), ctm_datasets),
            ("FederatedAVITM", lambda c: FederatedAVITM(AVITM(**avitm_kw, seed=c)),
             avitm_datasets)):
        steppers = [build(c) for c in range(len(datasets))]
        for stepper, data in zip(steppers, datasets):
            stepper.pre_fit(data)
        weights = [float(len(d)) for d in datasets]
        ms = {"step": [], "snapshot": [], "mean": [], "set": []}
        statuses = [[] for _ in steppers]
        fd.reset_launches()
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for stepper in steppers:
                stepper.train_mb_delta(snapshot=False)  # its loss's read syncs
            t1 = time.perf_counter()
            snaps = [stepper.get_gradients() for stepper in steppers]
            t2 = time.perf_counter()
            avg = weighted_mean(list(zip(weights, snaps)))
            t3 = time.perf_counter()
            for c, stepper in enumerate(steppers):
                statuses[c].append(stepper.delta_update_fit(avg))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, start, end in (("step", t0, t1), ("snapshot", t1, t2), ("mean", t2, t3),
                                    ("set", t3, t4)):
                ms[key].append((end - start) * 1e3)
            first = steppers[0].model.model.state_dict()
            for stepper in steppers[1:]:
                for key, val in stepper.model.model.state_dict().items():
                    check(torch.equal(val, first[key]),
                          f"{label}: {key} differs across clients after delta_update_fit")
        launches = dict(fd.LAUNCHES)
        nbytes = sum(v.nbytes for v in snaps[0].values())
        seq = [(s.current_mb, s.current_epoch, s.epoch_ended, s.finished) for s in statuses[0]]
        print(f"stepper (d) {label}: launches {nonzero(launches)}; client 0's StepStatus "
              f"(current_mb, current_epoch, epoch_ended, finished) {seq}; epoch losses "
              f"{[s.epoch_losses for s in steppers]}", flush=True)
        steady = {k: float(np.median(v[1:])) for k, v in ms.items()}
        print(f"stepper (d) steady exchanged step, {card}: {label}, {len(steppers)} clients: "
              f"median ms over steps 2-8: step {steady['step']:.3f}, snapshot "
              f"{steady['snapshot']:.3f} ({nbytes / 1e6:.1f} MB device to host per client), "
              f"mean {steady['mean']:.3f}, set {steady['set']:.3f}; total "
              f"{sum(steady.values()):.3f}", flush=True)
        for name in ("stats", "loss", "grads"):
            check(launches[name] == 16, f"{label}: {name} launched {launches[name]} times")
        want = [(1, 0, False, False), (2, 0, False, False), (3, 0, False, False),
                (4, 1, True, False), (5, 1, False, False), (6, 1, False, False),
                (7, 1, False, False), (8, 2, True, True)]
        for c in range(len(steppers)):
            got = [(s.current_mb, s.current_epoch, s.epoch_ended, s.finished)
                   for s in statuses[c]]
            check(got == want, f"{label} client {c}: StepStatus sequence {got}")
            check(all(np.isfinite(steppers[c].epoch_losses)), f"{label}: non-finite epoch loss")


def ctm_phase(card: str, notes: dict, raw=None, avitm_datasets=None,
              groups: dict | None = None) -> None:
    """Phase 8: (a) and (b) on phase 7(b)'s clients (``raw``, made here when
    not given), (c) (its rank programs from ``groups`` when given), then (d)
    on (a)'s datasets and phase 3's (``avitm_datasets``, made here when not
    given); timed."""
    t_phase = time.perf_counter()
    ctm_datasets = ctm_federated_phase(card, notes, raw or raw_text_corpora(card))
    ctm_sharded_phase(card, groups)
    stepper_phase(card, ctm_datasets, avitm_datasets or main_path_datasets())
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: the gRPC federation
# ---------------------------------------------------------------------------
FED_STEPS = 8  # global steps of phase 9: 1,024 documents per client, B=256, 2 epochs
#: Median ms per global step of the federation phases that ran (phase 11
#: prints its own beside phase 9's).
STEADY_MS: dict = {}


def _timed(obj, name: str, sink: list) -> None:
    """Replace ``obj.name`` by a wrapper that appends each call's
    ``(start, end)`` perf-counter pair to ``sink``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((t0, time.perf_counter()))

    setattr(obj, name, wrapper)


def _seconds(pairs) -> list:
    return [end - start for start, end in pairs]


def recorded_client():
    """A port ``Client`` class whose stepper records, per step, its step and
    snapshot times, loss, StepStatus, the server round of the aggregate it
    applied and a copy of its state on the card, and the last snapshot it
    sent (``snapshot``, host arrays)."""
    from gfedntm_tpu_torch.federation.client import Client

    class Recorded(Client):
        def join_federation(self):
            t0 = time.perf_counter()
            super().join_federation()
            self.join_s = time.perf_counter() - t0
            st = self.stepper
            self.first_batch = (st._schedule.indices[0].copy(), st._schedule.mask[0].copy())
            self.steps, self.snaps, self.sets = [], [], []
            self.losses, self.statuses, self.states, self.rounds = [], [], [], []
            _timed(st, "train_mb_delta", self.steps)
            snapshot = st.get_gradients

            def get_gradients():
                t0 = time.perf_counter()
                self.snapshot = snapshot()
                self.snaps.append((t0, time.perf_counter()))
                return self.snapshot

            st.get_gradients = get_gradients
            update = st.delta_update_fit

            def delta_update_fit(averaged):
                t0 = time.perf_counter()
                status = update(averaged)
                self.sets.append((t0, time.perf_counter()))
                self.losses.append(st.loss)
                self.statuses.append(status)
                self.rounds.append(self._servicer._applied_round)
                self.states.append({k: v.clone() for k, v in st.model.model.state_dict().items()})
                return status

            st.delta_update_fit = delta_update_fit

    return Recorded


def run_clients(clients, server, label: str, limit_s: float = 600.0, tick=None) -> float:
    """Run ``clients`` in threads until ``server`` is done, polling for a
    client that raised every second (each check fatal) and calling ``tick``
    (if given) at each poll; returns the seconds it took. The caller stops
    the server and the clients."""
    import threading

    errors: list = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below: the phase fails
            errors.append(f"client {client.client_id}: {type(err).__name__}: {err}")

    threads = [threading.Thread(target=run, args=(cl,), daemon=True) for cl in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while not server.wait_done(timeout=1.0 if tick is None else 0.1):
        check(not errors, f"{label}: {errors}")
        check(time.perf_counter() - t0 < limit_s,
              f"{label}: the federation did not finish in {limit_s:.0f} s")
        if tick is not None:
            tick()
    for t in threads:
        t.join(timeout=60)
    check(not errors, f"{label}: {errors}")
    check(all(not t.is_alive() for t in threads), f"{label}: a client did not stop")
    return time.perf_counter() - t0


def first_batch_kernels(label: str, setup, client, kw: dict) -> None:
    """K1-K3 on ``client``'s first batch against their plain versions: the
    server's initial state (``setup``, a ``GlobalSetup``), theta from its
    encoder."""
    from gfedntm_tpu_torch.federation.client import load_global_setup
    from gfedntm_tpu_torch.federation.server import build_template_model

    net = build_template_model("avitm", len(setup.vocab), kw)
    load_global_setup(net, setup)
    idx, mask_np = client.first_batch
    kernels_against_plain(f"{label}'s first batch", label, net, client.dataset.X[idx], mask_np)


def kernels_against_plain(case: str, label: str, net, x_np, mask_np) -> None:
    """K1-K3 on one batch (``x_np`` rows, ``mask_np``) of ``net``'s shapes
    against their plain versions: theta from its encoder, the template's
    beta and running statistics; prints the errors and the route."""
    import torch

    from gfedntm_tpu_torch.ops import _build
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    V, B, K = net.input_size, len(mask_np), net.n_components
    x = torch.as_tensor(x_np, device=net.device)
    mask = torch.as_tensor(mask_np, device=net.device, dtype=torch.float32)
    with torch.no_grad():
        theta = net.model.encode_theta(
            x, mask=mask, generator=torch.Generator(device=net.device).manual_seed(0)).theta
    bn = net.model.beta_batchnorm
    case = f"{case}, B={B} K={K} V={V}"
    st_args = (theta, net.model.beta.detach(), mask, bn.running_mean, bn.running_var, True)
    mean_, var_, m, s = fd.stats_reference(*st_args)
    lo_args = (theta, net.model.beta.detach(), x, mean_, var_, m, s)
    ref_loss = fd.loss_reference(*lo_args)
    gr_args = lo_args + (ref_loss[1], mask / B, mask, True)
    errs = [compare("mean,var,m,s", fd.stats(*st_args), (mean_, var_, m, s), case),
            compare("loss,rd", fd.loss(*lo_args), ref_loss, case),
            compare("g_theta,g_beta", fd.grads(*gr_args), fd.grads_reference(*gr_args), case)]
    route = ROUTE_NAMES[fd._route(_build.load(), "grads", B, K)]
    print(f"{label}: K1, K2, K3 on {case} ({route}) within "
          f"{', '.join(f'{e:.3e}' for e in errs)} of their plain versions", flush=True)


def federation_phase(card: str, notes: dict, raw=None) -> list:
    """Phase 9: a port ``FederatedServer`` at its defaults (the update gate,
    the divergence guardian, the journal, the checkpoints, the aggregation
    plane on the card) and two port ``Client``s over localhost gRPC on the
    card, in one process, on phase 7(b)'s raw-text clients (consensus
    V=66,001), K=50, H=(100, 100), B=256, 8 global steps; checked against
    the same two ``FederatedAVITM`` steppers driven in process. Returns the
    two clients' last snapshots (phase 10(a)'s inputs) and the server's
    last average."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.federated.aggregation import weighted_mean
    from gfedntm_tpu_torch.federated.stepper import FederatedAVITM
    from gfedntm_tpu_torch.federation.client import load_global_setup
    from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    t_phase = time.perf_counter()
    clients_raw = (raw or raw_text_corpora(card))[0]
    K, B, C = 50, 256, len(clients_raw)
    kw = dict(n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2, seed=0)
    save_dir = SCRATCH / "federation"
    shutil.rmtree(save_dir, ignore_errors=True)  # a fresh federation: nothing to recover

    Recorded = recorded_client()
    server_log = MetricsLogger(node="server", keep_records=True)
    server = FederatedServer(min_clients=C, family="avitm", model_kwargs=kw, max_iters=100,
                             save_dir=str(save_dir), metrics=server_log)
    check(server.device.type == "cuda", f"the server's template is on {server.device}")
    check(server.update_gate.check_finite and server.guardian is not None
          and server.journal_every == 1 and server.checkpoint_every == 25
          and server.aggregation_backend == "auto",
          "phase 9: the server is not at the JAX server's defaults")
    decode, mean, encode, journal = [], [], [], []
    _timed(server, "_collect_snapshots", decode)
    _timed(server.aggregator, "aggregate", mean)
    _timed(server, "_encode_push", encode)
    _timed(server, "_journal_round", journal)
    address = server.start("127.0.0.1:0")
    logs = [MetricsLogger(node=f"client{c + 1}", keep_records=True) for c in range(C)]
    clients = [Recorded(client_id=c + 1, corpus=clients_raw[c], server_address=address,
                        listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                        max_features=None, metrics=logs[c]) for c in range(C)]
    try:
        fd.reset_launches()
        run_s = run_clients(clients, server, "phase 9")
        torch.cuda.synchronize()
        launches = dict(fd.LAUNCHES)
    finally:
        server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    V = len(server.global_vocab)
    print(f"federation: {C} port clients joined a port server over gRPC on {server.device} "
          f"(global V={V}) in {[round(cl.join_s, 2) for cl in clients]} s; {server.global_iterations} "
          f"global steps; the run took {run_s:.2f} s; launches {nonzero(launches)}", flush=True)
    check(V == 66_001, f"phase 9: global vocabulary of {V} words, want 66,001")
    check(server.global_iterations == FED_STEPS,
          f"phase 9: {server.global_iterations} global steps, want {FED_STEPS}")
    engine = server.update_gate._engine
    check(server._agg_backend_resolved == "device" and engine is not None
          and engine.device.type == "cuda", "phase 9: the aggregation plane is not on the card")
    check(len(journal) == FED_STEPS and (save_dir / "checkpoints" / "journal.json").exists(),
          f"phase 9: {len(journal)} journal writes, want {FED_STEPS}")
    check(server_log.registry.counter("updates_rejected").value == 0
          and server_log.registry.counter("divergence_rollbacks").value == 0,
          "phase 9: the gate or the guardian acted on honest clients")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == C * FED_STEPS,
              f"phase 9: {name} launched {launches[name]} times, want {C * FED_STEPS}")
        notes[name] += f"; phase 9 gRPC federation: {launches[name]} launches"
    check((save_dir / "server_model.npz").exists(), "phase 9: no server_model.npz")
    check(bool(np.isfinite(server.global_betas).all()), "phase 9: non-finite server betas")
    for cl in clients:
        check(cl.stepper.model.device.type == "cuda", f"client {cl.client_id} not on the card")
        check(len(cl.states) == FED_STEPS, f"client {cl.client_id}: {len(cl.states)} aggregates")
    for step in range(FED_STEPS):
        for key, value in clients[0].states[step].items():
            check(torch.equal(value, clients[1].states[step][key]),
                  f"phase 9: {key} differs across clients after aggregate {step + 1}")

    # K1-K3 on the first client's first batch against their plain versions.
    first_batch_kernels("federation", server._setup_reply, clients[0], kw)

    # The same two steppers in process from the server's initial state.
    steppers = []
    for cl in clients:
        model = build_template_model("avitm", V, kw)
        load_global_setup(model, server._setup_reply)
        stepper = FederatedAVITM(model)
        stepper.pre_fit(cl.dataset)
        steppers.append(stepper)
    for step in range(FED_STEPS):
        snaps = []
        for st in steppers:
            snap = st.train_mb_delta()
            snaps.append((st._last_batch_size, snap))
        avg = weighted_mean(snaps)
        for c, (cl, st) in enumerate(zip(clients, steppers)):
            status = st.delta_update_fit(avg)
            check(st.loss == cl.losses[step], f"phase 9 client {c + 1} step {step + 1}: loss "
                  f"{cl.losses[step]!r} over the wire, {st.loss!r} in process")
            check(status == cl.statuses[step],
                  f"phase 9 client {c + 1} step {step + 1}: StepStatus differs")
            for key, value in st.model.model.state_dict().items():
                check(torch.equal(value, cl.states[step][key]),
                      f"phase 9 client {c + 1} step {step + 1}: {key} differs from the "
                      "in-process stepper's")
    check(np.array_equal(server.global_betas, steppers[0].get_topics_in_server()),
          "phase 9: the server's betas differ from the in-process steppers'")

    # Where a global step's time goes: median over steps 2-8.
    rounds = {r["span_id"]: r for r in server_log.events("span") if r["name"] == "round"}
    order = sorted(rounds.values(), key=lambda r: r["round"])
    child = {(r["parent_id"], r["name"]): r["seconds"] for r in server_log.events("span")
             if r["name"] in ("poll", "average", "push")}
    serve = [{(r.get("round"), r["method"]): r["seconds"] for r in log.events("span")
              if r["name"] == "serve"} for log in logs]
    split = {k: [] for k in ("round", "client step", "snapshot and encode",
                             "transfer and decode", "mean", "push and set", "journal")}
    for i, rnd in enumerate(order[1:], 1):
        sid = rnd["span_id"]
        poll, average, push = (child[(sid, n)] for n in ("poll", "average", "push"))
        steps = [b - a for cl in clients for a, b in [cl.steps[i]]]
        snapshot = [g for cl in clients for g in _seconds(cl.snaps[i:i + 1])]
        train = [sv[(i, "FederationClient.TrainStep")] for sv in serve]
        step_only = [t - g for t, g in zip(steps, snapshot)]
        split["round"].append(rnd["seconds"])
        split["client step"].append(float(np.mean(step_only)))
        split["snapshot and encode"].append(float(np.mean(
            [tr - so for tr, so in zip(train, step_only)])))
        split["transfer and decode"].append(poll - max(train) + _seconds(decode)[i])
        split["mean"].append(_seconds(mean)[i])
        split["journal"].append(_seconds(journal)[i])
        split["push and set"].append(average - _seconds(decode)[i] - _seconds(mean)[i] + push
                                     - _seconds(journal)[i])
    steady = {k: float(np.median(v)) * 1e3 for k, v in split.items()}
    STEADY_MS["phase 9"] = steady["round"]
    pulled = [r["bytes_pulled"] / C for r in order]
    pushed = [r["bytes_pushed"] / C for r in order]
    print(f"federation steady global step, {card}: median ms over steps 2-{FED_STEPS}: "
          f"{steady['round']:.3f} per global step ({C * B / steady['round'] * 1e3:.1f} docs/s), "
          f"split: client step {steady['client step']:.3f}, snapshot and encode "
          f"{steady['snapshot and encode']:.3f}, transfer and decode "
          f"{steady['transfer and decode']:.3f} (with the update gate, the stack onto the card "
          f"and its norms), mean on the card {steady['mean']:.3f}, push and set "
          f"{steady['push and set']:.3f} (with the guardian), journal write "
          f"{steady['journal']:.3f} (npz + JSON, fsynced)", flush=True)
    print(f"federation bytes per step and client, {card}: up (StepReply.shared) "
          f"{float(np.median(pulled)) / 1e6:.3f} MB, down (Aggregate) "
          f"{float(np.median(pushed)) / 1e6:.3f} MB; GlobalSetup "
          f"{server._setup_reply.ByteSize() / 1e6:.3f} MB", flush=True)
    print(f"federation first global step {order[0]['seconds'] * 1e3:.1f} ms; outside the "
          f"steps (the joins, the stop broadcast, the clients' results, server_model.npz) "
          f"{run_s - sum(r['seconds'] for r in order):.2f} s of the run", flush=True)

    # The same host work for one client with no other node in the process:
    # the wire's per-byte cost without contention for the interpreter.
    from gfedntm_tpu_torch.federation import codec as wire
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb

    st = steppers[0]
    alone = {k: [] for k in ("snapshot", "encode", "serialize", "parse", "decode", "mean",
                             "set")}
    for _ in range(5):
        t0 = time.perf_counter()
        snap = st.get_gradients()
        t1 = time.perf_counter()
        reply = pb.StepReply(client_id=1, shared=wire.flatdict_to_bundle(snap))
        t2 = time.perf_counter()
        data = reply.SerializeToString()
        t3 = time.perf_counter()
        parsed = pb.StepReply.FromString(data)
        t4 = time.perf_counter()
        back = wire.bundle_to_flatdict(parsed.shared)
        t5 = time.perf_counter()
        avg = weighted_mean([(256.0, back), (256.0, snap)])
        t6 = time.perf_counter()
        st.set_gradients(avg)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        for key, a, b in zip(alone, (t0, t1, t2, t3, t4, t5, t6), (t1, t2, t3, t4, t5, t6, t7)):
            alone[key].append((b - a) * 1e3)
    print(f"federation host work of one client alone, {card}: median ms over 5 of "
          + ", ".join(f"{k} {float(np.median(v)):.3f}" for k, v in alone.items())
          + f" ({len(data) / 1e6:.3f} MB StepReply)", flush=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return [cl.snapshot for cl in clients], server.last_average


# ---------------------------------------------------------------------------
# Phase 10: the server's planes at the JAX server's defaults
# ---------------------------------------------------------------------------
KILL_AFTER = 4  # phase 10(b) aborts its server once this many rounds are pushed


def kill_and_recover_phase(card: str, notes: dict, clients_raw) -> tuple:
    """Phase 10(b): a port server at the JAX server's defaults (but
    ``checkpoint_every=2``) under the delta codec, two port clients on phase
    7(b)'s corpora, 8 global steps; the server aborted after round 4 (its
    training thread joined), a replacement on the same ``save_dir``
    autorecovers from the journal and the clients reconnect by session
    token. Returns the clients' last snapshots and the last average."""
    import socket
    import threading

    import numpy as np
    import torch

    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    K, B, C = 50, 256, len(clients_raw)
    kw = dict(n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2, seed=0)
    save_dir = SCRATCH / "server_planes"
    shutil.rmtree(save_dir, ignore_errors=True)  # a fresh federation: nothing to recover
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    address = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    common = dict(min_clients=C, family="avitm", model_kwargs=kw, max_iters=100,
                  save_dir=str(save_dir), checkpoint_every=2, wire_codec="delta")
    logs = [MetricsLogger(node="server", keep_records=True),
            MetricsLogger(node="server2", keep_records=True)]
    journal, ckpt = [], []
    server1 = FederatedServer(metrics=logs[0], **common)
    _timed(server1, "_journal_round", journal)
    _timed(server1, "_save_round_checkpoint", ckpt)
    server1.start(address)
    client_log = MetricsLogger(node="clients", keep_records=True)
    Recorded = recorded_client()
    clients = [Recorded(client_id=c + 1, corpus=clients_raw[c], server_address=address,
                        listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                        max_features=None, metrics=client_log, liveness_timeout=10.0,
                        watchdog_poll_s=0.1, reconnect_window=120.0, wire_codec="delta")
               for c in range(C)]
    errors: list = []

    def run(client):
        try:
            client.run()
        except BaseException as err:  # reported below: the phase fails
            errors.append(f"client {client.client_id}: {type(err).__name__}: {err}")

    threads = [threading.Thread(target=run, args=(cl,), daemon=True) for cl in clients]
    server2 = None
    try:
        fd.reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while server1.global_iterations < KILL_AFTER:
            check(not errors, f"phase 10(b): {errors}")
            check(time.perf_counter() - t0 < 300, "phase 10(b): round 4 never came")
            time.sleep(0.01)
        server1.abort()
        server1._train_thread.join(timeout=120)
        check(not server1._train_thread.is_alive(), "phase 10(b): the aborted loop never exited")
        killed_at = server1.global_iterations
        t_restart = time.perf_counter()
        server2 = FederatedServer(metrics=logs[1], **common)
        resumed = server2.maybe_autorecover()
        recover_s = time.perf_counter() - t_restart
        _timed(server2, "_journal_round", journal)
        _timed(server2, "_save_round_checkpoint", ckpt)
        server2.start(address)
        while not server2.wait_done(timeout=0.5):
            check(not errors, f"phase 10(b): {errors}")
            check(time.perf_counter() - t0 < 600, "phase 10(b): the recovered run did not end")
        for t in threads:
            t.join(timeout=60)
        torch.cuda.synchronize()
        launches = dict(fd.LAUNCHES)
        check(not errors, f"phase 10(b): {errors}")
        check(all(not t.is_alive() for t in threads), "phase 10(b): a client did not stop")
    finally:
        for server in (server1, server2):
            if server is not None:
                server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    reg2, creg = logs[1].registry, client_log.registry
    after = [r for r in logs[1].events("span") if r["name"] == "round"]
    before = [r for r in logs[0].events("span") if r["name"] == "round"]
    steps = sum(len(cl.steps) for cl in clients)
    print(f"server planes (b), {card}: killed after round {killed_at}, recovered from the "
          f"{server2._recovered_source} at round {resumed} in {recover_s:.3f} s "
          f"(maybe_autorecover); session restores {reg2.counter('session_restores').value}, "
          f"client reconnections {creg.counter('client_reconnections').value}, codec_ref_miss "
          f"{reg2.counter('codec_ref_miss').value}/{creg.counter('codec_ref_miss').value}, "
          f"rpcs deduplicated {reg2.counter('rpcs_deduplicated').value}; "
          f"{server2.global_iterations} global steps; local steps {steps}; launches "
          f"{nonzero(launches)}", flush=True)
    check(server2._recovered_source == "journal", f"recovered from {server2._recovered_source}")
    check(resumed is not None and resumed >= killed_at - 1,
          f"phase 10(b): resumed at {resumed}, killed at {killed_at}")
    check(reg2.counter("session_restores").value == C, "phase 10(b): session restores")
    check(reg2.counter("codec_ref_miss").value == 0 and creg.counter("codec_ref_miss").value == 0,
          "phase 10(b): codec_ref_miss")
    check(server2.global_iterations >= FED_STEPS and
          all(len(cl.states) == FED_STEPS and cl.stepper.finished for cl in clients),
          f"phase 10(b): {server2.global_iterations} rounds, "
          f"{[len(cl.states) for cl in clients]} aggregates per client")
    check(bool(np.isfinite(server2.global_betas).all()), "phase 10(b): non-finite betas")
    # The recovered server restarts once quorum_fraction (0.5) of the
    # restored members are back, so the first client to reconnect may take
    # rounds alone; every round both clients applied leaves them equal.
    by_round = [dict(zip(cl.rounds, cl.states)) for cl in clients]
    both = sorted(set(by_round[0]) & set(by_round[1]))
    alone = sorted(set(by_round[0]) ^ set(by_round[1]))
    print(f"server planes (b): rounds applied by both clients {both}, by one {alone}",
          flush=True)
    check(len(both) >= KILL_AFTER, f"phase 10(b): only rounds {both} reached both clients")
    for rnd in both:
        for key, value in by_round[0][rnd].items():
            check(torch.equal(value, by_round[1][rnd][key]),
                  f"phase 10(b): {key} differs across clients after round {rnd}'s aggregate")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == steps,
              f"phase 10(b): {name} launched {launches[name]} times, the steppers took {steps}")
        notes[name] += f"; phase 10(b) kill and recovery: {launches[name]} launches"
    first_batch_kernels("server planes (b)", server2._setup_reply, clients[0], kw)
    nbytes = sum(f.stat().st_size for f in (save_dir / "checkpoints").iterdir()
                 if f.name.startswith("journal"))
    restart_s = min(b for _a, b in journal if b > t_restart) - t_restart
    ms = [r["seconds"] * 1e3 for r in before], [r["seconds"] * 1e3 for r in after]
    print(f"server planes (b) times, {card}: journal write median "
          f"{float(np.median(_seconds(journal))) * 1e3:.3f} ms ({nbytes / 1e6:.1f} MB npz + JSON, "
          f"fsynced; {len(journal)} writes), checkpoint write median "
          f"{float(np.median(_seconds(ckpt))) * 1e3:.3f} ms ({len(ckpt)} writes); "
          f"maybe_autorecover {recover_s:.3f} s; restart to the first recovered round pushed "
          f"{restart_s:.3f} s (the clients' liveness window is 10 s); ms per global step, "
          f"median: before the kill {float(np.median(ms[0][1:])):.3f} (rounds 2-{len(ms[0])}), "
          f"after {float(np.median(ms[1][1:])):.3f} (rounds {resumed + 2}-"
          f"{resumed + len(ms[1])}); first round after the restart {ms[1][0]:.3f}", flush=True)
    return [cl.snapshot for cl in clients], server2.last_average


def aggregation_plane_phase(card: str, snapshots: list, average: dict) -> None:
    """Phase 10(a): the aggregation plane at full width (V=66,001, D =
    10,052,752): two client snapshots, an honest perturbation, one scaled by
    100 and one with a NaN, through the engine on the card and the numpy
    oracle."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.federated import aggregation as agg
    from gfedntm_tpu_torch.federation.device_agg import DeviceAggEngine, FlatPlane, stack_round
    from gfedntm_tpu_torch.federation.sanitize import UpdateGate, update_norm

    rng = np.random.default_rng(0)
    s0, s1 = snapshots
    # The last average in the template's dtypes (the int counters average
    # to float64), as the server restores it.
    g = {k: np.asarray(v, dtype=np.asarray(s0[k]).dtype) for k, v in average.items()}
    plane = FlatPlane(g)
    n_f32 = plane.dim - sum(int(np.asarray(g[k]).size) for k in plane.non_f32_keys)
    check(n_f32 == 10_052_752, f"phase 10(a): {n_f32} float32 values in the plane")
    honest = {k: (v + rng.normal(0.0, float(np.std(np.asarray(s0[k], np.float64) - v)) or 1e-3,
                                 size=np.shape(v))).astype(v.dtype)
              if v.dtype == np.float32 else v for k, v in g.items()}
    scaled = {k: (np.asarray(v) * np.float32(100)).astype(np.asarray(v).dtype)
              if np.asarray(v).dtype == np.float32 else v for k, v in s0.items()}
    nan = {k: np.array(v, copy=True) for k, v in s1.items()}
    nan["params/beta"].reshape(-1)[12345] = np.nan
    rows = [s0, s1, honest, scaled, nan]
    pairs = [(256.0, r) for r in rows]
    engine = DeviceAggEngine()
    check(engine.device.type == "cuda", f"phase 10(a): engine on {engine.device}")

    def timed(fn, reps=3):
        out = fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    sr, stack_ms = timed(lambda: stack_round(engine, plane, pairs, current_global=g))
    finite = stack_round(engine, plane, pairs[:4])
    line = {}

    # The weighted mean, bitwise.
    dev, line["weighted mean"] = timed(lambda: agg.WeightedMean()(finite))
    ref, np_ms = timed(lambda: agg.weighted_mean(pairs[:4]))
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(dev[k])
        check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"phase 10(a): weighted mean {k} is not numpy's, bitwise")
    numpy_ms = {"weighted mean": np_ms}

    # The gate: norms and admissions.
    (counts, norms), line["gate norms"] = timed(lambda: engine.gate_stats(sr.mat, sr.gvec))
    want, numpy_ms["gate norms"] = timed(lambda: [update_norm(r, g) for r in rows])
    for i in range(4):
        check(abs(norms[i] - want[i]) <= 1e-6 * want[i],
              f"phase 10(a): norm {i} {norms[i]!r} vs update_norm {want[i]!r}")
    check(list(counts) == [0, 0, 0, 0, 1], f"phase 10(a): non-finite counts {list(counts)}")
    decisions = []
    for eng in (None, engine):
        gate = UpdateGate()
        gate.set_template(g)
        gate.set_engine(eng)
        res = gate.admit_round([(c, 256.0, r) for c, r in enumerate(rows)], g, 0)
        decisions.append(([c for c, _w, _s in res.accepted],
                          [(r.client_id, r.reason) for r in res.rejected]))
    check(decisions[0] == decisions[1] == ([0, 1, 2], [(4, "nonfinite"), (3, "norm_outlier")]),
          f"phase 10(a): admissions numpy {decisions[0]}, engine {decisions[1]}")

    # Trimmed mean, median (odd and even N) and Krum's distances.
    errs = {}
    for name, est, stacked, oracle in (
            ("trimmed mean", agg.TrimmedMean(0.2), sr, pairs),
            ("median, N=5", agg.Median(), sr, pairs),
            ("median, N=4", agg.Median(), finite, pairs[:4])):
        dev, line[name] = timed(lambda: est(stacked))
        ref, numpy_ms[name] = timed(lambda: est(oracle), reps=1)
        err = 0.0
        for k in ref:
            a, b = np.asarray(ref[k], np.float64), np.asarray(dev[k], np.float64)
            check(np.array_equal(np.isnan(a), np.isnan(b)), f"phase 10(a): {name} {k} NaNs")
            ok = ~np.isnan(a)
            err = max(err, float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(a[ok]), 1.0),
                                        initial=0.0)))
        errs[name] = err
        check(err <= 1e-6, f"phase 10(a): {name} differs from numpy by {err:.3e}")
    d2, line["Krum distances"] = timed(lambda: engine.krum_d2(finite))
    flat = np.stack([plane.flatten(r) for r in rows[:4]])
    t0 = time.perf_counter()
    sq32 = np.einsum("ij,ij->i", flat, flat)
    d2_np = sq32[:, None] + sq32[None, :] - 2.0 * (flat @ flat.T)
    numpy_ms["Krum distances"] = (time.perf_counter() - t0) * 1e3
    f64 = flat.astype(np.float64)
    gram = f64 @ f64.T
    sq = np.diagonal(gram)
    d2_exact = sq[:, None] + sq[None, :] - 2.0 * gram
    errs["Krum distances"] = float(np.max(np.abs(d2 - d2_exact)) / sq.max())
    errs["numpy float32 Krum distances"] = float(np.max(np.abs(d2_np - d2_exact)) / sq.max())
    check(errs["Krum distances"] <= 1e-6,
          f"phase 10(a): Krum distances {errs['Krum distances']:.3e} of the scale off")
    # The same clients selected; their order follows scores that differ in
    # rounding only (numpy ranks on its float32 distances), so the Krum
    # estimate (their weighted mean) is held within 1e-6, as the others.
    chosen = [sorted(int(i) for i in agg.krum_select(x, 4, 1)) for x in (d2, d2_np)]
    check(chosen[0] == chosen[1] and 3 not in chosen[0], f"phase 10(a): Krum picks {chosen}")
    dev_k, line["Krum estimate"] = timed(lambda: agg.Krum(1)(finite))
    ref_k, numpy_ms["Krum estimate"] = timed(lambda: agg.Krum(1)(pairs[:4]), reps=1)
    errs["Krum estimate"] = max(
        float(np.max(np.abs(np.asarray(ref_k[k], np.float64) - np.asarray(dev_k[k], np.float64))
                     / np.maximum(np.abs(np.asarray(ref_k[k], np.float64)), 1.0), initial=0.0))
        for k in ref_k)
    check(errs["Krum estimate"] <= 1e-6,
          f"phase 10(a): Krum estimate differs by {errs['Krum estimate']:.3e}")
    print(f"server planes (a), {card}: D={plane.dim} ({n_f32} float32 values and "
          f"{len(plane.non_f32_keys)} int counters), N=5 (two client snapshots, honest, x100, "
          f"NaN); stack onto the card {stack_ms:.3f} ms; engine ms vs numpy ms: "
          + ", ".join(f"{k} {line[k]:.3f} vs {numpy_ms.get(k, float('nan')):.3f}"
                      for k in line)
          + "; errors: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (of the gram's scale for Krum); admissions {decisions[1]}", flush=True)


def server_planes_phase(card: str, notes: dict, raw=None, phase9=None) -> None:
    """Phase 10: (b) kill and autorecover on the card, then (a) the
    aggregation plane at full width on phase 9's client snapshots (or
    (b)'s, when phase 9 did not run)."""
    t_phase = time.perf_counter()
    clients_raw = (raw or raw_text_corpora(card))[0]
    snaps, average = kill_and_recover_phase(card, notes, clients_raw)
    aggregation_plane_phase(card, *(phase9 or (snaps, average)))
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the privacy and observation planes
# ---------------------------------------------------------------------------
DP_SIGMA = 0.01  # noise multiplier of phase 11 (std = sigma * clip / n on the aggregate)
DP_CLIP = 1.0
DP_DELTA = 1e-5
OPS_ROUTES = ("/healthz", "/ready", "/metrics", "/status", "/status?full=1", "/status.fleet",
              "/alerts")
#: Phase 11(a)'s SLOs: one that holds (the warm polls' p99 latency stays under
#: ten minutes) and one that fires at the first round's tick (more than one
#: poll answered fleet-wide).
SLO_SPECS = [
    {"name": "poll-p99", "metric": "client_poll_s", "agg": "p99", "op": "<=", "threshold": 600.0},
    {"name": "one-poll", "metric": "client_polls", "agg": "value", "op": "<=", "threshold": 1.0},
]


def replayed_eps(steps: int) -> list:
    """The port accountant's epsilon after each of ``steps`` rounds at
    (DP_SIGMA, DP_DELTA, q=1)."""
    from gfedntm_tpu_torch.privacy import PrivacyAccountant

    acct = PrivacyAccountant(sigma=DP_SIGMA, delta=DP_DELTA)
    return [acct.step(q=1.0) for _ in range(steps)]


def fetch_routes(port: int) -> dict:
    """GET every ops route; returns ``{route: (status, body, ms)}``."""
    import urllib.error
    import urllib.request

    out = {}
    for route in OPS_ROUTES:
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as resp:
                out[route] = (resp.status, resp.read(), (time.perf_counter() - t0) * 1e3)
        except urllib.error.HTTPError as err:
            out[route] = (err.code, err.read(), (time.perf_counter() - t0) * 1e3)
    return out


def capturing_client():
    """Phase 9's recorded client that also keeps its ``ClientSanitizer``'s
    inputs and output and the StepReply of application ``CAPTURE_AT``."""
    Recorded = recorded_client()

    class Capturing(Recorded):
        CAPTURE_AT = 3

        def serve_training(self):
            import numpy as np

            self.captured = {}
            sanitizer = self._dp_sanitizer
            apply = sanitizer.apply

            def record(params, reference, round_index):
                index = sanitizer.applications
                out = apply(params, reference, round_index)
                if index == self.CAPTURE_AT:
                    self.captured.update(
                        params={k: np.array(v, copy=True) for k, v in params.items()},
                        reference={k: np.array(v, copy=True) for k, v in reference.items()},
                        round=round_index, index=index)
                return out

            sanitizer.apply = record
            super().serve_training()
            servicer = self._servicer
            train_step = servicer._train_step

            def keep_reply(request):
                reply = train_step(request)
                if sanitizer.applications == self.CAPTURE_AT + 1 and "reply" not in self.captured:
                    self.captured["reply"] = reply.SerializeToString()
                return reply

            servicer._train_step = keep_reply

    return Capturing


def dp_federation(card: str, clients_raw, mode: str, label: str, budget: float = 0.0,
                  planes: bool = False, tick=None, server_cls=None):
    """One phase-11 federation: a port server (``server_cls``, by default
    ``FederatedServer``) at the JAX defaults with ``dp=mode`` and two port
    clients on phase 7(b)'s corpora (client DP when ``mode == "client"``), 8
    global steps; ``planes`` turns on the quality plane with its guard, the
    ops endpoint with SLOs, and incident dumps on every node. Returns
    (server, clients, logs, launches, run_s, base directory)."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    K, B, C = 50, 256, len(clients_raw)
    kw = dict(n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=2, seed=0)
    base = SCRATCH / "privacy_ops" / mode
    shutil.rmtree(base, ignore_errors=True)  # a fresh federation: nothing to recover
    base.mkdir(parents=True)
    dp = dict(dp=mode, dp_clip=DP_CLIP, dp_sigma=DP_SIGMA, dp_delta=DP_DELTA, dp_budget=budget,
              dp_seed=11)
    extra = {}
    if planes:
        ref = base / "quality_ref.txt"
        ref.write_text("\n".join(d for c in clients_raw for d in c.documents) + "\n")
        extra = dict(quality_every=1, quality_guard=True, quality_ref=str(ref), ops_port=0,
                     slo_specs=SLO_SPECS, dump_dir=str(base / "incidents"))
    server_log = MetricsLogger(node="server", keep_records=True)
    server = (server_cls or FederatedServer)(
        min_clients=C, family="avitm", model_kwargs=kw, max_iters=100,
        save_dir=str(base / "server"), metrics=server_log, **dp, **extra)
    check(server.device.type == "cuda", f"{label}: the server's template is on {server.device}")
    check(server.update_gate.check_finite and server.guardian is not None
          and server.aggregation_backend == "auto",
          f"{label}: the server is not at the JAX server's defaults")
    address = server.start("127.0.0.1:0")
    logs = [MetricsLogger(node=f"client{c + 1}", keep_records=True) for c in range(C)]
    cls = capturing_client() if mode == "client" else recorded_client()
    client_dp = dict(dp) if mode == "client" else {}
    clients = [cls(client_id=c + 1, corpus=clients_raw[c], server_address=address,
                   listen_address="127.0.0.1:0", advertise_host="127.0.0.1", max_features=None,
                   metrics=logs[c],
                   dump_dir=str(base / f"client{c + 1}") if planes else None, **client_dp)
               for c in range(C)]
    try:
        fd.reset_launches()
        run_s = run_clients(clients, server, label, tick=tick)
        torch.cuda.synchronize()
        launches = dict(fd.LAUNCHES)
    finally:
        server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    check(server.global_iterations == FED_STEPS,
          f"{label}: {server.global_iterations} global steps, want {FED_STEPS}")
    check(server._agg_backend_resolved == "device"
          and server.update_gate._engine.device.type == "cuda",
          f"{label}: the aggregation plane is not on the card")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == C * FED_STEPS,
              f"{label}: {name} launched {launches[name]} times, want {C * FED_STEPS}")
    for cl in clients:
        check(cl.stepper.model.device.type == "cuda", f"client {cl.client_id} not on the card")
        check(all(math.isfinite(loss) for loss in cl.losses), f"{label}: a non-finite loss")
        check(len(cl.states) == FED_STEPS, f"{label}: client {cl.client_id}: "
              f"{len(cl.states)} aggregates")
    for step in range(FED_STEPS):
        for key, value in clients[0].states[step].items():
            check(torch.equal(value, clients[1].states[step][key]),
                  f"{label}: {key} differs across clients after aggregate {step + 1}")
    check(server_log.registry.counter("divergence_rollbacks").value == 0,
          f"{label}: the guardian rolled the federation back")
    ledger = server_log.events("privacy_budget")
    want = replayed_eps(FED_STEPS)
    check([r["steps"] for r in ledger] == list(range(1, FED_STEPS + 1))
          and all(r["q"] == 1.0 and r["mode"] == mode for r in ledger),
          f"{label}: ledger rows {[(r['steps'], r['q'], r['mode']) for r in ledger]}")
    check([r["eps"] for r in ledger] == want,
          f"{label}: ledger eps {[r['eps'] for r in ledger]} vs replayed {want}")
    first_batch_kernels(label, server._setup_reply, clients[0], kw)
    rounds = sorted((r for r in server_log.events("span") if r["name"] == "round"),
                    key=lambda r: r["round"])
    STEADY_MS[label] = float(np.median([r["seconds"] for r in rounds[1:]])) * 1e3
    return server, clients, logs, launches, run_s, base


def server_dp_phase(card: str, notes: dict, clients_raw):
    """Phase 11(a): server-mode DP with the quality, ops, fleet, SLO and
    incident planes on. Returns the server (its engine and last average
    feed 11(c))."""
    import numpy as np

    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.privacy import host_noise_vector
    from gfedntm_tpu_torch.utils.observability import render_prometheus

    label = "privacy and ops (a)"
    eps = replayed_eps(FED_STEPS)
    budget = (eps[3] + eps[4]) / 2  # crossed at the fifth aggregated round
    times = {k: [] for k in ("noise", "quality step", "contribution stats", "fleet ingest",
                             "incident capture")}
    fetched = {}
    holder = {}

    def tick():
        server = holder.get("server")
        if server is not None and not fetched and server.global_iterations >= 3:
            fetched.update(fetch_routes(server.ops_actual_port))

    class Timed(FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            holder["server"] = self
            _timed(self, "_quality_step", times["quality step"])
            _timed(self, "_observe_contributions", times["contribution stats"])
            _timed(self.fleet, "ingest_bytes", times["fleet ingest"])
            _timed(self._incident_trigger, "capture", times["incident capture"])
            _timed(self._dp_noiser, "_noise_vec", times["noise"])

    server, clients, logs, launches, run_s, base = dp_federation(
        card, clients_raw, "server", label, budget=budget, planes=True, tick=tick,
        server_cls=Timed)
    reg = server.metrics.registry
    for name in ("stats", "loss", "grads"):
        notes[name] += f"; phase 11(a) server-mode DP with the planes: {launches[name]} launches"
    # The noiser: one application per aggregated round, on the card.
    noise_events = server.metrics.events("dp_noise_applied")
    check(server._dp_noiser.applications == FED_STEPS and len(noise_events) == FED_STEPS
          and [r["index"] for r in noise_events] == list(range(FED_STEPS))
          and all(r["backend"] == "device" for r in noise_events),
          f"{label}: noiser applications {server._dp_noiser.applications}, events "
          f"{[(r['index'], r['backend']) for r in noise_events]}")
    check(server._dp_noiser.device_engine is server.update_gate._engine,
          f"{label}: the noise is not drawn on the aggregation engine")
    check(server.update_gate.max_update_norm == DP_CLIP, f"{label}: the gate's clip is not dp_clip")
    # The quality plane.
    quality = server.metrics.events("quality_computed")
    check([r["round"] for r in quality] == list(range(FED_STEPS)),
          f"{label}: quality rounds {[r['round'] for r in quality]}")
    check(reg.counter("quality_errors").value == 0,
          f"{label}: {reg.counter('quality_errors').value} quality errors")
    check(all(r["npmi"] is not None and -1.0 <= r["npmi"] <= 1.0 for r in quality),
          f"{label}: NPMI {[r['npmi'] for r in quality]}")
    # The ops endpoint, fetched during the run.
    check(sorted(fetched) == sorted(OPS_ROUTES) and all(v[0] == 200 for v in fetched.values()),
          f"{label}: routes {({k: v[0] for k, v in fetched.items()})}")
    status = json.loads(fetched["/status"][1])
    check(status["privacy"] is not None and status["model_quality"] is not None,
          f"{label}: /status privacy {status['privacy']}, model_quality "
          f"{status['model_quality'] is not None}")
    full = json.loads(fetched["/status?full=1"][1])
    check(sorted(str(c["client_id"]) for c in full["clients"]) == ["1", "2"],
          f"{label}: /status?full=1 roster {full['clients']}")
    fleet = json.loads(fetched["/status.fleet"][1])
    nodes = sorted(n["node"] for n in fleet["top_nodes"])
    check(nodes == ["client1", "client2", "server"] and status["fleet"]["nodes"] == 3,
          f"{label}: fleet nodes {nodes}")
    metrics_text = fetched["/metrics"][1].decode()
    check("gfedntm_fleet_" in metrics_text and 'node="client1"' in metrics_text,
          f"{label}: /metrics carries no fleet families")
    # SLOs: exactly the firing one fired.
    alerts = {a["alert"]: a for a in server.slo.status()["alerts"]}
    check(alerts["one-poll"]["ever_fired"] and alerts["one-poll"]["state"] == "firing"
          and not alerts["poll-p99"]["ever_fired"],
          f"{label}: alerts {alerts}")
    # The budget, crossed once; two incidents, each with both clients' rings.
    exceeded = server.metrics.events("privacy_budget_exceeded")
    check(len(exceeded) == 1 and exceeded[0]["round"] == 4,
          f"{label}: privacy_budget_exceeded {exceeded}")
    incidents = {}
    for f in (base / "incidents").iterdir():
        ident, _, node = f.name[len("inc-"):-len(".json")].partition("__")
        incidents.setdefault(ident, set()).add(node)
    reasons = sorted(r["reason"] for r in server.metrics.events("incident_captured"))
    check(reasons == ["privacy_budget", "slo_alert"]
          and sorted(incidents.values(), key=sorted) == [{"client1", "client2", "server"}] * 2,
          f"{label}: incidents {reasons}, bundles {incidents}")

    # Each plane's ms per round.
    ms = {k: [x * 1e3 for x in _seconds(v)] for k, v in times.items()}
    noise_dim = next(r["dim"] for r in noise_events)
    host = []
    for i in range(3):
        t0 = time.perf_counter()
        host_noise_vector(noise_dim, 0.005, 11, i)
        host.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    render_prometheus(reg.snapshot())
    render_ms = (time.perf_counter() - t0) * 1e3
    med = {k: float(np.median(v)) if v else float("nan") for k, v in ms.items()}
    print(f"{label}, {card}: {FED_STEPS} global steps in {run_s:.2f} s; launches "
          f"{nonzero(launches)}; eps after each round {[round(e, 3) for e in eps]} (budget "
          f"{budget:.3f}, crossed at round 4); NPMI per round "
          f"{[round(r['npmi'], 4) for r in quality]}; unhealthy quality rounds "
          f"{reg.counter('unhealthy_quality_rounds').value:g}; updates clipped to {DP_CLIP} "
          f"{reg.counter('updates_clipped').value:g}; incidents {reasons}, "
          f"{sum(len(v) for v in incidents.values())} bundles", flush=True)
    print(f"{label} ms per round, {card}: noise on the card (D={noise_dim}) median "
          f"{med['noise']:.3f} (first {ms['noise'][0]:.3f}), host_noise_vector "
          f"{float(np.median(host)):.3f}; quality step {med['quality step']:.3f} (contribution "
          f"stats {med['contribution stats']:.3f} of it); fleet ingest per report "
          f"{med['fleet ingest']:.3f} ({len(ms['fleet ingest'])} reports); /metrics render "
          f"{render_ms:.3f} (HTTP fetch {fetched['/metrics'][2]:.3f}, "
          f"{len(fetched['/metrics'][1])} bytes); incident capture "
          f"{', '.join(f'{x:.3f}' for x in ms['incident capture'])}; routes "
          + ", ".join(f"{k} {v[2]:.1f}" for k, v in fetched.items()), flush=True)
    return server


def client_dp_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 11(b): client-mode DP on both clients and the server."""
    import numpy as np

    from gfedntm_tpu_torch.federation import codec
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
    from gfedntm_tpu_torch.privacy import ClientSanitizer

    label = "privacy and ops (b)"
    server, clients, logs, launches, run_s, _base = dp_federation(
        card, clients_raw, "client", label)
    for name in ("stats", "loss", "grads"):
        notes[name] += f"; phase 11(b) client-mode DP: {launches[name]} launches"
    for cl, log in zip(clients, logs):
        events = log.events("dp_noise_applied")
        check([r["index"] for r in events] == list(range(FED_STEPS))
              and all(r["mode"] == "client" for r in events),
              f"{label}: client {cl.client_id} noise events {[r['index'] for r in events]}")
    check(server._dp_noiser is None and server.aggregator.noiser is None
          and not server.metrics.events("dp_noise_applied"), f"{label}: the server added noise")
    # A host replay of one captured application: bitwise the wire's tensors.
    cap = clients[0].captured
    replay = ClientSanitizer(clients[0].dp, client_id=1)
    replay.applications = cap["index"]
    t0 = time.perf_counter()
    want = replay.apply(cap["params"], cap["reference"], cap["round"])
    replay_ms = (time.perf_counter() - t0) * 1e3
    wire = codec.bundle_to_flatdict(pb.StepReply.FromString(cap["reply"]).shared)
    check(sorted(wire) == sorted(want) and all(
        np.asarray(want[k]).dtype == wire[k].dtype
        and np.asarray(want[k]).tobytes() == wire[k].tobytes() for k in want),
          f"{label}: the replayed sanitizer differs from the wire")
    norms = [r["norm"] for r in logs[0].events("dp_noise_applied")]
    print(f"{label}, {card}: {FED_STEPS} global steps in {run_s:.2f} s; launches "
          f"{nonzero(launches)}; client update norms before the clip {[round(n, 3) for n in norms]}"
          f"; one application replayed on the host in {replay_ms:.1f} ms, bitwise the wire's "
          f"{len(wire)} tensors; server ledger at q=1 {server.privacy_accountant.steps} steps",
          flush=True)


def device_noise_phase(card: str, server) -> None:
    """Phase 11(c): the device noise at phase 10(a)'s plane (D = 10,052,752)
    on 11(a)'s engine."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.federation.device_agg import FlatPlane
    from gfedntm_tpu_torch.privacy import host_noise_vector

    label = "privacy and ops (c)"
    engine = server.update_gate._engine
    avg = server.last_average
    plane = FlatPlane({k: v for k, v in avg.items() if np.asarray(v).dtype == np.float32})
    check(plane.dim == 10_052_752, f"{label}: D={plane.dim}")
    std = 0.25

    def draw(index):
        t0 = time.perf_counter()
        vec = engine.noise_vector(plane, std=std, seed=11, index=index)
        torch.cuda.synchronize()
        return vec, (time.perf_counter() - t0) * 1e3

    a, ms_a = draw(5)
    b, ms_b = draw(5)
    c, ms_c = draw(6)
    check(a.dtype == np.float32 and a.shape == (plane.dim,), f"{label}: {a.dtype} {a.shape}")
    check(np.array_equal(a, b), f"{label}: two draws at (seed, index) differ")
    a64, c64 = a.astype(np.float64), c.astype(np.float64)
    corr = float(np.corrcoef(a64, c64)[0, 1])
    mean, sd = float(a64.mean()), float(a64.std())
    check(abs(corr) < 2e-3, f"{label}: corr(index, index+1) = {corr:.3e}")
    check(abs(mean) < 2e-3 * std, f"{label}: mean {mean:.3e} vs std {std}")
    check(abs(sd / std - 1.0) < 1e-3, f"{label}: std {sd:.6f} vs {std}")
    t0 = time.perf_counter()
    host_noise_vector(plane.dim, std, 11, 5)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"{label}, {card}: D={plane.dim}, std {std}: draws bitwise equal per (seed, index); "
          f"corr(index 5, 6) {corr:.3e}, mean {mean:.3e} ({mean / std:.3e} std), std "
          f"{sd:.6f} ({sd / std - 1:.3e} relative); ms on the card with the copy back "
          f"{ms_a:.3f}, {ms_b:.3f}, {ms_c:.3f} vs host_noise_vector {host_ms:.3f}", flush=True)


def privacy_ops_phase(card: str, notes: dict, raw=None) -> None:
    """Phase 11: (a) server-mode DP with every observation plane on, (b)
    client-mode DP, (c) the device noise at full width."""
    t_phase = time.perf_counter()
    clients_raw = (raw or raw_text_corpora(card))[0]
    server = server_dp_phase(card, notes, clients_raw)
    client_dp_phase(card, notes, clients_raw)
    device_noise_phase(card, server)
    p9 = STEADY_MS.get("phase 9")
    print(f"privacy and ops ms per global step (median over steps 2-{FED_STEPS}), {card}: "
          f"(a) {STEADY_MS['privacy and ops (a)']:.3f}, (b) {STEADY_MS['privacy and ops (b)']:.3f}"
          f"; phase 9 " + (f"{p9:.3f}" if p9 is not None else "not run in this call"), flush=True)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 12: cohort, async and push pacing, and the simulated-client fleet
# ---------------------------------------------------------------------------
PACING_SEED = 1  # phase 12(a)'s pacing_seed
PACING_ALPHA = 0.5  # phase 12(b)'s staleness_alpha
PACING_MIN_AGGS = 8  # each of 12(a)-(c) aggregates at least this often
# Under push pacing ``local_steps`` is the length of a client's own round.
# At 1, three free-running clients in one interpreter push faster than the
# server decodes (a drained update costs it more host time than a push
# costs its client), and the drains grow round by round (2, 8, 10, ... 30
# updates on the card); 16 local steps a push keep them at about B = 2.
# 32 epochs give each client 8 pushes, so 12(c) aggregates about 12 times.
PUSH_LOCAL_STEPS = 16
PUSH_EPOCHS = 32
SIM_RUNS = (("cohort", 100, 16, 6), ("cohort", 1_000, 16, 6), ("push", 100, 16, 6),
            ("push", 1_000, 16, 6), ("sync", 100, 0, 2))  # (mode, N, K or B, rounds)


def pacing_corpora(card: str, raw=None) -> list:
    """Phase 12's three raw-text clients: phase 7(b)'s two and a third from
    the same generator with its own seed (``seed=1``: its own topics, so the
    consensus vocabulary grows past 66,001)."""
    from gfedntm_tpu_torch import RawCorpus, generate_synthetic_corpus

    clients = list((raw or raw_text_corpora(card))[0])
    t0 = time.perf_counter()
    third = generate_synthetic_corpus(vocab_size=100_000, n_topics=50, n_docs=1024, n_nodes=1,
                                      materialize_docs=True, seed=1)
    clients.append(RawCorpus(documents=third.nodes[0].documents))
    print(f"pacing: a third raw-text client of {len(clients[2])} documents made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return clients


def view_digest(view: dict) -> str:
    """SHA-256 over a flat state's keys, dtypes, shapes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for key in sorted(view):
        arr = np.ascontiguousarray(view[key])
        h.update(f"{key}|{arr.dtype}|{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def pacing_client(views: bool):
    """Phase 9's recorded client that also records the loss of every local
    step (a push round that applies no aggregate still steps) and, with
    ``views``, a digest of every downlink view it decodes, by round."""
    Recorded = recorded_client()

    class Pacing(Recorded):
        def join_federation(self):
            super().join_federation()
            st = self.stepper
            self.step_losses, self.views = [], {}
            step = st.train_mb_delta

            def train_mb_delta(snapshot=True):
                out = step(snapshot)
                self.step_losses.append(st.loss)
                return out

            st.train_mb_delta = train_mb_delta
            if views:
                decode = self._downlink.decode

                def recorded_decode(bundle, round_idx=None):
                    out = decode(bundle, round_idx=round_idx)
                    self.views[int(round_idx)] = view_digest(out)
                    return out

                self._downlink.decode = recorded_decode

    return Pacing


def pacing_federation(card: str, notes: dict, clients_raw, label: str, num_epochs: int = 2,
                      views: bool = False, **server_kw):
    """One phase 12 federation: a port server at the JAX defaults but for
    ``server_kw`` (the pacing and its codec), three port clients over
    localhost gRPC on the card, K=50, H=(100, 100), B=256, ``num_epochs``;
    with ``views``, digests of the server's and the clients' downlink views
    by round; the checks every part shares. Returns (server, clients, server
    log, times)."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    K, B, C = 50, 256, len(clients_raw)
    kw = dict(n_components=K, hidden_sizes=(100, 100), batch_size=B, num_epochs=num_epochs,
              seed=0)
    save_dir = SCRATCH / f"pacing_{label}"
    shutil.rmtree(save_dir, ignore_errors=True)  # a fresh federation: nothing to recover
    server_log = MetricsLogger(node="server", keep_records=True)
    server = FederatedServer(min_clients=C, family="avitm", model_kwargs=kw, max_iters=100,
                             save_dir=str(save_dir), metrics=server_log, **server_kw)
    check(server.device.type == "cuda", f"phase 12({label}): the server is on {server.device}")
    times = {k: [] for k in ("decode", "mean", "encode", "journal")}
    _timed(server, "_collect_snapshots", times["decode"])
    _timed(server.aggregator, "aggregate", times["mean"])
    _timed(server, "_encode_push", times["encode"])
    _timed(server, "_advance_broadcast", times["encode"])
    _timed(server, "_journal_round", times["journal"])
    server.views = {}
    if views:
        advance = server._downlink_enc.advance

        def recorded_advance(average, round_idx):
            bundle, view = advance(average, round_idx=round_idx)
            server.views[int(round_idx)] = view_digest(view)
            return bundle, view

        server._downlink_enc.advance = recorded_advance
    address = server.start("127.0.0.1:0")
    logs = [MetricsLogger(node=f"client{c + 1}", keep_records=True) for c in range(C)]
    Pacing = pacing_client(views)
    clients = [Pacing(client_id=c + 1, corpus=clients_raw[c], server_address=address,
                      listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                      max_features=None, metrics=logs[c]) for c in range(C)]
    try:
        fd.reset_launches()
        run_s = run_clients(clients, server, f"phase 12({label})")
        torch.cuda.synchronize()
        launches = dict(fd.LAUNCHES)
    finally:
        server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    reg = server_log.registry
    steps = sum(len(cl.steps) for cl in clients)
    V = len(server.global_vocab)
    print(f"pacing ({label}), {card}: {server.pacing.spec_id}, codec "
          f"{server.wire_codec.codec_id}, {C} port clients, global V={V}; "
          f"{server.global_iterations} aggregations in {run_s:.2f} s; local steps "
          f"{[len(cl.steps) for cl in clients]}; launches {nonzero(launches)}; "
          f"quorum skips {reg.counter('quorum_skipped_rounds').value}, codec_ref_miss "
          f"{reg.counter('codec_ref_miss').value}, updates rejected by the gate "
          f"{reg.counter('updates_rejected').value}, rollbacks "
          f"{reg.counter('divergence_rollbacks').value}", flush=True)
    drains = [e["buffered"] for e in server_log.events("push_aggregated")
              + server_log.events("async_aggregated")]
    check(server.global_iterations >= PACING_MIN_AGGS,
          f"phase 12({label}): {server.global_iterations} aggregations (drains of {drains} "
          f"updates), want >= {PACING_MIN_AGGS}")
    check(server._agg_backend_resolved == "device", f"phase 12({label}): aggregation plane")
    for cl in clients:
        check(cl.stepper.finished and cl.stepper.model.device.type == "cuda",
              f"phase 12({label}): client {cl.client_id} did not finish on the card")
        check(len(cl.step_losses) == len(cl.steps)
              and bool(np.isfinite(cl.step_losses).all()),
              f"phase 12({label}): client {cl.client_id}: non-finite losses")
        check(logs[cl.client_id - 1].registry.counter("codec_ref_miss").value == 0,
              f"phase 12({label}): client {cl.client_id} missed a codec reference")
    check(reg.counter("codec_ref_miss").value == 0,
          f"phase 12({label}): the server missed a codec reference")
    check((save_dir / "server_model.npz").exists()
          and bool(np.isfinite(server.global_betas).all()),
          f"phase 12({label}): server_model.npz missing or not finite")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == steps,
              f"phase 12({label}): {name} launched {launches[name]} times, the clients took "
              f"{steps} local steps")
        notes[name] += f"; phase 12({label}) {server.pacing.spec_id}: {launches[name]} launches"
    first_batch_kernels(f"pacing ({label})", server._setup_reply, clients[0], kw)
    return server, clients, server_log, dict(times, run=run_s)


def pacing_times(card: str, label: str, server, clients, server_log, times) -> float:
    """Print phase 12's ms per aggregation, split as phase 9's where the
    pacing has the part, beside phase 9's ms per global step; returns the
    median ms per aggregation (aggregations 2 onwards)."""
    import numpy as np

    rounds = sorted((r for r in server_log.events("span") if r["name"] == "round"),
                    key=lambda r: r["round"])[1:]
    med = {k: float(np.median(_seconds(v[1:]))) * 1e3 if len(v) > 1 else float("nan")
           for k, v in times.items() if k != "run"}
    step = float(np.median([b - a for cl in clients for a, b in cl.steps[1:]])) * 1e3
    snap = float(np.median([b - a for cl in clients for a, b in cl.snaps[1:]])) * 1e3
    per_agg = float(np.median([r["seconds"] for r in rounds])) * 1e3
    p9 = STEADY_MS.get("phase 9")
    print(f"pacing ({label}) ms per aggregation, {card}: median over aggregations 2-"
          f"{len(rounds) + 1}: {per_agg:.3f} per aggregation (its round span; wall "
          f"{times['run'] / server.global_iterations * 1e3:.3f}: {server.global_iterations} "
          f"in {times['run']:.2f} s with the joins and the stop); split: local step {step:.3f} "
          f"(median over every step; an exchanged step includes its snapshot, median "
          f"{snap:.3f}), transfer and decode (with the "
          f"update gate) {med['decode']:.3f}, mean on the card {med['mean']:.3f}, downlink "
          f"encode {med['encode']:.3f}, journal write {med['journal']:.3f}; phase 9 ms per "
          f"global step " + (f"{p9:.3f}" if p9 is not None else "not run in this call"),
          flush=True)
    return per_agg


def cohort_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 12(a): ``cohort:2`` of 3 under the delta codec, ``pacing_seed=1``:
    every roster is the sampler replayed for its (seed, round, eligible),
    the rosters rotate, no quorum skip and no reference miss, and every
    recipient of round r holds the server's round-r view bitwise."""
    import numpy as np

    from gfedntm_tpu_torch.federation import pacing

    samples = []
    select = pacing.CohortEngine.select_cohort

    def recorded_select(self, iteration, active):
        cohort = select(self, iteration, active)
        samples.append((iteration, [r.client_id for r in active],
                        [r.client_id for r in cohort]))
        return cohort

    pacing.CohortEngine.select_cohort = recorded_select
    try:
        server, clients, log, times = pacing_federation(
            card, notes, clients_raw, "a", views=True, pacing_policy="cohort:2",
            pacing_seed=PACING_SEED, wire_codec="delta")
    finally:
        pacing.CohortEngine.select_cohort = select
    check(log.registry.counter("quorum_skipped_rounds").value == 0,
          "phase 12(a): a round was skipped below quorum")
    events = [(e["round"], e["cohort"]) for e in log.events("cohort_sampled")]
    check(events == [(it, roster) for it, _active, roster in samples],
          "phase 12(a): cohort_sampled events differ from the sampler's rosters")
    for iteration, active, roster in samples:
        if len(active) <= 2:
            want = active
        else:
            rng = np.random.default_rng((PACING_SEED, iteration))
            picked = {active[int(i)] for i in rng.choice(len(active), size=2, replace=False)}
            want = [c for c in active if c in picked]
        check(roster == want, f"phase 12(a): round {iteration}'s roster {roster}, the "
              f"sampler replayed for eligible {active} gives {want}")
    full = {tuple(roster) for _it, active, roster in samples if len(active) == 3}
    check(len(full) > 1, f"phase 12(a): the rosters do not rotate ({full})")
    held = 0
    for cl in clients:
        for rnd, digest in cl.views.items():
            check(server.views.get(rnd) == digest,
                  f"phase 12(a): client {cl.client_id} holds another view of round {rnd} "
                  "than the server's")
            held += 1
    check(held == sum(len(cl.states) for cl in clients) and held > 0,
          f"phase 12(a): {held} views compared, {sum(len(cl.states) for cl in clients)} "
          "aggregates applied")
    print(f"pacing (a): rosters {[(it, roster) for it, _a, roster in samples]}; {held} "
          f"recipient views bitwise the server's round views", flush=True)
    STEADY_MS["pacing (a)"] = pacing_times(card, "a", server, clients, log, times)


def async_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 12(b): ``async:2`` with ``staleness_alpha=0.5``: every discount
    the drain applies is ``1/(1+s)^0.5`` for its server-clamped s."""
    from gfedntm_tpu_torch.federation.server import FederatedServer

    drains = []
    collect = FederatedServer._collect_snapshots

    def recorded_collect(self, replies, iteration, was_suspect=frozenset(),
                         weight_scale=None, staleness=None):
        drains.append((iteration, dict(weight_scale or {}), dict(staleness or {})))
        return collect(self, replies, iteration, was_suspect, weight_scale=weight_scale,
                       staleness=staleness)

    FederatedServer._collect_snapshots = recorded_collect
    try:
        server, clients, log, times = pacing_federation(
            card, notes, clients_raw, "b", pacing_policy="async:2",
            staleness_alpha=PACING_ALPHA)
    finally:
        FederatedServer._collect_snapshots = collect
    aggs = log.events("async_aggregated")
    check(len(aggs) == server.global_iterations == len(drains),
          f"phase 12(b): {len(aggs)} async_aggregated events, {len(drains)} drains")
    stale = []
    for iteration, scale, stal in drains:
        check(bool(scale) and sorted(scale) == sorted(stal), f"phase 12(b): drain {iteration}")
        for cid, factor in scale.items():
            want = 1.0 / (1.0 + stal[cid]) ** PACING_ALPHA
            check(factor == want, f"phase 12(b): client {cid} at {iteration}: discount "
                  f"{factor!r}, 1/(1+{stal[cid]})^0.5 = {want!r}")
            stale.append(stal[cid])
    print(f"pacing (b): {len(drains)} drains of {[len(s) for _i, s, _t in drains]} updates; "
          f"staleness per update {stale}, each discount 1/(1+s)^0.5 exactly", flush=True)
    STEADY_MS["pacing (b)"] = pacing_times(card, "b", server, clients, log, times)


def push_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 12(c): ``push:2`` under the delta codec, each push a round of
    ``PUSH_LOCAL_STEPS`` local steps, ``PUSH_EPOCHS`` epochs: the clients
    push, the server aggregates at least eight times without polling, no
    reference miss, and ``/status`` reads the push engine."""
    server, clients, log, times = pacing_federation(
        card, notes, clients_raw, "c", num_epochs=PUSH_EPOCHS, pacing_policy="push:2",
        wire_codec="delta", local_steps=PUSH_LOCAL_STEPS)
    reg = log.registry
    received = reg.counter("push_updates_received").value
    aggs = log.events("push_aggregated")
    status = server._status()["pacing"]
    steps = sum(len(cl.steps) for cl in clients)
    pushes = sum(cl.metrics.registry.counter("client_pushes").value for cl in clients)
    print(f"pacing (c): {received} pushes received ({pushes} sent, {steps} local steps), "
          f"{len(aggs)} push_aggregated of {[e['buffered'] for e in aggs]} updates, /status "
          f"pacing {status}", flush=True)
    want = sum(-(-len(cl.steps) // PUSH_LOCAL_STEPS) for cl in clients)
    check(received > 0 and received == pushes == want,
          f"phase 12(c): {received} pushes received, {pushes} sent, {steps} local steps in "
          f"rounds of {PUSH_LOCAL_STEPS}")
    check(len(aggs) >= PACING_MIN_AGGS, f"phase 12(c): {len(aggs)} push_aggregated events")
    check(status["policy"] == "push:2" and status["push"] is True,
          f"phase 12(c): /status pacing {status}")
    check(reg.counter("rpcs_deduplicated").value == 0, "phase 12(c): a push was replayed")
    STEADY_MS["pacing (c)"] = pacing_times(card, "c", server, clients, log, times)


def rss_mb() -> "tuple[float, float | None]":
    """This process's resident set and its peak since the last reset
    (``VmRSS``, ``VmHWM``; ``None`` where the kernel reports no peak), MB."""
    fields = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                fields[key] = float(value.split()[0]) / 1024.0
    return fields["VmRSS"], fields.get("VmHWM")


def push_rounds(server, servicers, template, fan: int, rounds: int, deadline: float) -> None:
    """Drive a push-paced sim fleet round by round: ``fan`` round-robin
    pushes (each reply applied), then wait for their aggregation, so every
    round drains exactly B updates and its bytes do not depend on the race
    between this driver and the engine thread."""
    order, i = sorted(servicers), 0
    while not server.training_done.is_set() and server.global_iterations < rounds:
        done = server.global_iterations
        pushed = 0
        while pushed < fan:
            servicer = servicers[order[i % len(order)]]
            i += 1
            if servicer.finished:
                continue
            update = servicer.build_update(template)
            agg = server.PushUpdate(update, None)
            server.byte_counter.note(agg, update)
            servicer.apply(agg)
            pushed += 1
        while server.global_iterations == done and not server.training_done.is_set():
            check(time.perf_counter() < deadline, "sim fleet: a push round never aggregated")
            time.sleep(0.001)


def sim_fleet_run(mode: str, n: int, fan: int, rounds: int) -> dict:
    """One ``scripts/scale_bench.py`` configuration on the port's sim fleet,
    its server on the card: set-up and run seconds, bytes per round counted
    before the stop broadcast, loopback calls, and the process's peak RSS
    over the run (reset first through ``/proc/self/clear_refs``)."""
    import numpy as np

    from gfedntm_tpu_torch.federation.simfleet import SimFleetServer, make_sim_fleet

    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5")
        peak_reset = rss_mb()[1] is not None
    except OSError:
        peak_reset = False
    rss_before = rss_mb()[0]
    save_dir = SCRATCH / f"simfleet_{mode}_{n}"
    shutil.rmtree(save_dir, ignore_errors=True)
    pacing_spec = {"cohort": f"cohort:{fan}", "push": f"push:{fan}", "sync": "sync"}[mode]
    # The bytes are read just before the stop broadcast (an O(N) fan-out of
    # stop messages, not a round's cost). A poll-driven run can end before
    # make_sim_fleet returns, so the hook goes on the class first.
    counted = {}
    stop_broadcast = SimFleetServer._stop_broadcast

    def before_stop(self, stubs):
        counted["bytes"] = self.byte_counter.sent + self.byte_counter.recv
        stop_broadcast(self, stubs)

    SimFleetServer._stop_broadcast = before_stop
    t0 = time.perf_counter()
    try:
        server, servicers, template = make_sim_fleet(
            n, steps=rounds + 2, pacing_policy=pacing_spec, max_iters=rounds,
            save_dir=str(save_dir), checkpoint_every=0, journal_every=0,
            round_backoff_s=0.02)
    except BaseException:
        SimFleetServer._stop_broadcast = stop_broadcast
        raise
    setup_s = time.perf_counter() - t0
    counter = server.byte_counter
    t1 = time.perf_counter()
    try:
        if mode == "push":
            push_rounds(server, servicers, template, fan, rounds, t1 + 300)
        check(server.wait_done(timeout=300), f"sim fleet {mode} N={n} did not finish")
    finally:
        server.stop(grace=0.1)
        SimFleetServer._stop_broadcast = stop_broadcast
    run_s = time.perf_counter() - t1
    check(server.device.type == "cuda" and server._agg_backend_resolved == "device",
          f"sim fleet {mode} N={n}: the server is not on the card")
    check(server.global_iterations == rounds,
          f"sim fleet {mode} N={n}: {server.global_iterations} rounds, want {rounds}")
    check(all(bool(np.isfinite(np.asarray(v)).all()) for v in server.last_average.values()),
          f"sim fleet {mode} N={n}: non-finite average")
    rss_now, peak = rss_mb()
    return {"mode": mode, "n": n, "fan": fan, "rounds": rounds, "setup_s": setup_s,
            "run_s": run_s, "bytes_per_round": counted["bytes"] / rounds,
            "calls": counter.calls, "rss_before_mb": rss_before, "rss_mb": rss_now,
            "peak_rss_mb": peak if peak_reset else None,
            "lifetime_peak_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0}


class _Count(logging.Handler):
    """Counts the records it sees (and prints none)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        self.n += 1


def sim_fleet_phase(card: str) -> None:
    """Phase 12(d): the simulated fleet with its server on the card; cohort
    and push bytes per round at N=1,000 within 1.25x of N=100. The gate's
    warnings (it rejects some stale sim updates as norm outliers) are
    counted, not printed."""
    runs = {}
    server_log = logging.getLogger("FederatedServer")
    for mode, n, fan, rounds in SIM_RUNS:
        counter = _Count()
        server_log.addHandler(counter)
        server_log.propagate = False
        try:
            res = sim_fleet_run(mode, n, fan, rounds)
        finally:
            server_log.removeHandler(counter)
            server_log.propagate = True
        res["warnings"] = counter.n
        runs[(mode, n)] = res
        peak = (f"{res['peak_rss_mb']:.1f} MB" if res["peak_rss_mb"] is not None
                else "not measured")
        print(f"sim fleet, {card}: {mode}" + (f":{fan}" if fan else "") + f" N={n}, "
              f"{rounds} rounds: set-up {res['setup_s']:.3f} s, run {res['run_s']:.3f} s, "
              f"{res['bytes_per_round']:.0f} bytes per round, {res['calls']} loopback calls, "
              f"{res['warnings']} server warnings (gate rejections), peak RSS over the run {peak} (RSS {res['rss_before_mb']:.1f} MB before, "
              f"{res['rss_mb']:.1f} after; the process's lifetime peak "
              f"{res['lifetime_peak_mb']:.1f} MB)", flush=True)
    for mode in ("cohort", "push"):
        lo, hi = (f(n for m, n in runs if m == mode) for f in (min, max))
        ratio = runs[(mode, hi)]["bytes_per_round"] / runs[(mode, lo)]["bytes_per_round"]
        print(f"sim fleet: {mode} bytes per round N={hi} / N={lo} = {ratio:.4f}", flush=True)
        check(ratio <= 1.25, f"phase 12(d): {mode} bytes per round grew {ratio:.3f}x from "
              f"N={lo} to N={hi}")


def pacing_phase(card: str, notes: dict, raw=None) -> list:
    """Phase 12: (a) cohort, (b) async and (c) push pacing with three real
    port clients at phase 9's width, (d) the simulated fleet. Returns the
    three raw-text clients (phase 13's first three)."""
    t_phase = time.perf_counter()
    clients_raw = pacing_corpora(card, raw)
    cohort_phase(card, notes, clients_raw)
    async_phase(card, notes, clients_raw)
    push_phase(card, notes, clients_raw)
    sim_fleet_phase(card)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return clients_raw


HIER_RELAYS = (101, 102)  # phase 13's relay ids, disjoint from the member ids 1-4
# 13(a)'s flat and relay runs train one epoch (4 local steps a client, 4
# root rounds): its checks compare the two runs round by round, and client
# 1's profiler window [2, 3) closes when round 3 begins.
HIER_FLAT_EPOCHS = 1
RELAY_KILL_AFTER = 2  # 13(b) aborts relay 101 once the root has pushed this many rounds
RELAY_LOSS_AFTER = 2  # 13(c) aborts relay 102 once the root has pushed this many rounds
# 13(b): relay 101's members' liveness window: above a member's idle gaps
# between two polls (up to ~12 s: a root round is 4-14 s of host work in
# this one interpreter), and about as long as the outage before the respawn
# (two rounds over relay 102 alone, ~15 s), so that the members first knock
# once the relay is back: a channel that has failed for a while backs off
# for seconds before it connects again (33 s offline at a 12 s window,
# 23 s from the respawn to the first recovered round at 25 s).
HIER_LIVENESS_S = 18.0
# 13(c): relay 102's members' liveness and reconnect windows, tight (as the
# JAX relayloss scenario's) so that they re-home while relay 101's members
# still train: re-homing races the end of the run.
DOOMED_LIVENESS_S = 3.0
DOOMED_RECONNECT_S = 2.0
# 13(b) stops at the root's eighth round and 13(c) at its sixth: the members
# of the relay that was out miss the rounds of its outage, and finishing
# their schedules would add rounds of 6-13 s of host work each (two
# journaled relays in (b)) to the script. (b) keeps the rounds its checks
# need after the kill: the grace's two rounds over relay 102 alone, the
# respawn, and the respawned relay's first rounds (19-30 s after the
# respawn); (c)'s members re-home within a round of the kill, and the
# run keeps three more rounds to show them live at the root.
HIER_CRASH_ROUNDS = 8
HIER_LOSS_ROUNDS = 6
# 13(b): the root's probation of relay 101. A dead relay's polls fail at
# once, with retries at the next round and two after; the respawn waits for
# the 2-round grace, so at the default of 3 the relay had one round over
# relay 102 alone (~5 s) to come back from its journal before the root
# dropped it for good, which its autorecovery does not always make. At 4 the
# next retry falls past HIER_CRASH_ROUNDS.
HIER_PROBATION = 4
BETA_TOL = 1e-4  # 13(a): final beta, hierarchy vs flat (tests/test_scaleout.py:790-806)


def hierarchy_corpora(card: str, clients_raw=None) -> list:
    """Phase 13's four raw-text clients: phase 12's three and a fourth from
    the same generator with ``seed=2``."""
    from gfedntm_tpu_torch import RawCorpus, generate_synthetic_corpus

    clients = list(clients_raw or pacing_corpora(card))
    t0 = time.perf_counter()
    fourth = generate_synthetic_corpus(vocab_size=100_000, n_topics=50, n_docs=1024, n_nodes=1,
                                       materialize_docs=True, seed=2)
    clients.append(RawCorpus(documents=fourth.nodes[0].documents))
    print(f"hierarchy: a fourth raw-text client of {len(clients[3])} documents made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return clients


def free_address() -> str:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    address = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    return address


class Federation13:
    """One phase 13 federation of port nodes on the card, in this process:
    a root at the JAX defaults (but ``root_kw``), the relays of
    ``shards`` (relay id -> member ids; none: the members join the root),
    each with a ``save_dir`` (its shard journal) when ``journaled``, and
    recorded clients (``client_kw``: client id -> keywords); every node
    with its own ``MetricsLogger``."""

    def __init__(self, label: str, clients_raw, shards=None, root_kw=None, client_kw=None,
                 journaled: bool = False, num_epochs: int = 2):
        import numpy as np

        from gfedntm_tpu_torch.federation.server import FederatedServer
        from gfedntm_tpu_torch.utils.observability import MetricsLogger

        self.label = label
        self.kw = dict(n_components=50, hidden_sizes=(100, 100), batch_size=256,
                       num_epochs=num_epochs, seed=0)
        self.save = SCRATCH / f"hierarchy_{label}"
        shutil.rmtree(self.save, ignore_errors=True)  # a fresh federation
        self.root_log = MetricsLogger(node="root", keep_records=True)
        n_up = len(shards) if shards else len(clients_raw)
        root_kw = dict(root_kw or {})
        self.root = FederatedServer(min_clients=n_up, family="avitm", model_kwargs=self.kw,
                                    max_iters=root_kw.pop("max_iters", 100),
                                    save_dir=str(self.save / "root"),
                                    metrics=self.root_log, **root_kw)
        check(self.root.device.type == "cuda", f"phase 13({label}): the root is on "
              f"{self.root.device}")
        self.averages = []
        self.times = {k: [] for k in ("root decode", "root mean")}
        aggregate = self.root.aggregator.aggregate

        def recorded_aggregate(snapshots, current_global=None):
            t0 = time.perf_counter()
            out = aggregate(snapshots, current_global=current_global)
            self.times["root mean"].append((t0, time.perf_counter()))
            self.averages.append({k: np.array(v, copy=True) for k, v in out.items()})
            return out

        self.root.aggregator.aggregate = recorded_aggregate
        _timed(self.root, "_collect_snapshots", self.times["root decode"])
        self.root_ready = []
        ready = self.root.ReadyForTraining

        def recorded_ready(request, context):
            self.root_ready.append((int(request.client_id), bool(request.recovered)))
            return ready(request, context)

        self.root.ReadyForTraining = recorded_ready
        self.root_address = self.root.start("127.0.0.1:0")
        self.relay_args, self.relays, self.relay_logs = {}, {}, {}
        home = {}
        for rid, members in (shards or {}).items():
            self.relay_args[rid] = dict(
                relay_id=rid, upstream_address=self.root_address, min_members=len(members),
                listen_address=free_address(), advertise_host="127.0.0.1",
                save_dir=str(self.save / f"relay{rid}") if journaled else None)
            address = self.spawn(rid)
            home.update({cid: address for cid in members})
        Recorded = recorded_client()
        self.logs = [MetricsLogger(node=f"client{c + 1}", keep_records=True)
                     for c in range(len(clients_raw))]
        self.clients = [
            Recorded(client_id=c + 1, corpus=clients_raw[c],
                     server_address=home.get(c + 1, self.root_address),
                     listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                     max_features=None, metrics=self.logs[c],
                     **(client_kw or {}).get(c + 1, {}))
            for c in range(len(clients_raw))]

    def spawn(self, rid: int) -> str:
        """Start relay ``rid`` (again, after an abort: on its address and
        ``save_dir``, recovering its shard first); returns its address."""
        from gfedntm_tpu_torch.federation.relay import RelayNode
        from gfedntm_tpu_torch.utils.observability import MetricsLogger

        log = MetricsLogger(node=f"relay{rid}", keep_records=True)
        relay = RelayNode(metrics=log, **self.relay_args[rid])
        relay.resumed = relay.maybe_autorecover()
        relay.acks = []
        ready = relay.ReadyForTraining

        def recorded_ready(request, context):
            ack = ready(request, context)
            relay.acks.append((int(request.client_id), ack.code))
            return ack

        relay.ReadyForTraining = recorded_ready
        self.relays.setdefault(rid, []).append(relay)
        self.relay_logs.setdefault(rid, []).append(log)
        return relay.start()

    def run(self, tick=None) -> float:
        import torch

        from gfedntm_tpu_torch.ops import fused_decoder as fd

        try:
            fd.reset_launches()
            run_s = run_clients(self.clients, self.root, f"phase 13({self.label})",
                                tick=tick)
            torch.cuda.synchronize()
            self.launches = dict(fd.LAUNCHES)
        finally:
            self.root.stop(grace=0.5, join_timeout=30)
            for relays in self.relays.values():
                for relay in relays:
                    relay.shutdown(grace=0.5)
            for cl in self.clients:
                cl.shutdown(grace=0.5)
        return run_s

    def check_leaves(self, notes: dict, scheduled: bool = True) -> None:
        """Every leaf finished (with ``scheduled``, its whole schedule; else
        stopped by the root with its results) on the card with finite
        losses; K1-K3 launched once per local step the leaves took."""
        import numpy as np

        steps = sum(len(cl.steps) for cl in self.clients)
        for cl in self.clients:
            done = cl.stepper.finished if scheduled else cl.results is not None
            check(done and cl.stepper.model.device.type == "cuda",
                  f"phase 13({self.label}): client {cl.client_id} did not finish on the card")
            check(bool(np.isfinite(cl.losses).all()) and len(cl.losses) > 0,
                  f"phase 13({self.label}): client {cl.client_id}: non-finite losses")
        check(bool(np.isfinite(self.root.global_betas).all()),
              f"phase 13({self.label}): non-finite betas")
        for name in ("stats", "loss", "grads"):
            check(self.launches[name] == steps,
                  f"phase 13({self.label}): {name} launched {self.launches[name]} times, the "
                  f"leaves took {steps} local steps")
            notes[name] += f"; phase 13({self.label}): {self.launches[name]} launches"

    def counter(self, logs, name: str) -> float:
        return sum(log.registry.counter(name).value for log in logs)


def trace_kernels(path) -> dict:
    """Kernel events by family in a Chrome trace ``torch.profiler`` wrote."""
    names = [e.get("name", "") for e in json.loads(Path(path).read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    return {fam: sum(fam in n for n in names) for fam in TENSOR_CORE_FAMILIES}


def check_profiler(label: str, prof, log) -> None:
    events = [e["event"] for e in log.records if e.get("event", "").startswith("profiler_")]
    written = prof.trace_path is not None and Path(prof.trace_path).is_file()
    kernels = trace_kernels(prof.trace_path) if written else {}
    size = f"{Path(prof.trace_path).stat().st_size / 1e6:.1f} MB" if written else "not written"
    print(f"hierarchy ({label}): RoundProfiler rounds [{prof.start_round}, {prof.stop_round}): "
          f"events {events}, profiler_failures {log.registry.counter('profiler_failures').value}, "
          f"trace {prof.trace_path} ({size}), kernel events {kernels}", flush=True)
    check(events == ["profiler_started", "profiler_stopped"],
          f"phase 13({label}): profiler events {events}")
    check(log.registry.counter("profiler_failures").value == 0 and written,
          f"phase 13({label}): profiler_failures, or no trace")
    check(all(kernels.get(fam, 0) > 0 for fam in TENSOR_CORE_FAMILIES),
          f"phase 13({label}): the trace names kernels {kernels}")


def hierarchy_flat_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 13(a): the four clients flat under a port root, then under the
    root and relays 101 (clients 1, 2) and 102 (clients 3, 4), both under
    the default codec; client 1 carries ``RoundProfiler(dir, "2:3")``."""
    import numpy as np

    import gfedntm_tpu_torch.federation.relay as relay_mod
    from gfedntm_tpu_torch.federation.relay import RelayNode
    from gfedntm_tpu_torch.utils.observability import RoundProfiler

    flat = Federation13("a-flat", clients_raw, num_epochs=HIER_FLAT_EPOCHS)
    flat_s = flat.run()
    flat.check_leaves(notes)
    prof = RoundProfiler(str(SCRATCH / "profile_a"), "2:3", metrics=None)
    shards = {HIER_RELAYS[0]: (1, 2), HIER_RELAYS[1]: (3, 4)}
    relay_times = {k: [] for k in ("decode and gate", "pre-reduction", "upstream encode")}
    weights = {}
    decode_and_admit = relay_mod.decode_and_admit

    def timed_admit(answered, decode, gate, current, round_idx, **kwargs):
        t0 = time.perf_counter()
        try:
            return decode_and_admit(answered, decode, gate, current, round_idx, **kwargs)
        finally:
            relay_times["decode and gate"].append((t0, time.perf_counter()))
            members = tuple(sorted(rec.client_id for rec, _r in answered))
            weights[(int(round_idx), members)] = sum(r.nr_samples for _rec, r in answered)

    pre_reduce, encode = RelayNode._pre_reduce, RelayNode._encode_upstream

    def timed(fn, sink):
        def wrapper(self, *args):
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                sink.append((t0, time.perf_counter()))
        return wrapper

    relay_mod.decode_and_admit = timed_admit
    RelayNode._pre_reduce = timed(pre_reduce, relay_times["pre-reduction"])
    RelayNode._encode_upstream = timed(encode, relay_times["upstream encode"])
    try:
        hier = Federation13("a", clients_raw, shards=shards, num_epochs=HIER_FLAT_EPOCHS)
        prof.metrics = hier.logs[0]
        hier.clients[0].profiler = prof
        prof.device = hier.clients[0].device
        hier_s = hier.run()
    finally:
        relay_mod.decode_and_admit = decode_and_admit
        RelayNode._pre_reduce, RelayNode._encode_upstream = pre_reduce, encode
    hier.check_leaves(notes)
    root, R = hier.root, hier.root.global_iterations
    V = len(root.global_vocab)
    print(f"hierarchy (a), {card}: global V={V}; flat {flat.root.global_iterations} rounds in "
          f"{flat_s:.2f} s, hierarchy {R} rounds in {hier_s:.2f} s; root members "
          f"{sorted(c.client_id for c in root.federation.get_clients())}; local steps "
          f"{[len(cl.steps) for cl in hier.clients]}; launches {nonzero(hier.launches)}",
          flush=True)
    check(sorted(c.client_id for c in root.federation.get_clients()) == list(HIER_RELAYS),
          "phase 13(a): the root's membership is not the two relays")
    check(R == flat.root.global_iterations, f"phase 13(a): {R} hierarchy rounds, "
          f"{flat.root.global_iterations} flat")
    for rid, members in shards.items():
        events = hier.relay_logs[rid][0].events("relay_preaggregated")
        check([e["round"] for e in events] == list(range(R)),
              f"phase 13(a): relay {rid} pre-aggregated rounds {[e['round'] for e in events]}")
        for e in events:
            want = weights[(e["round"], members)]
            check(e["admitted"] == 2 and e["weight"] == want,
                  f"phase 13(a): relay {rid} round {e['round']}: admitted {e['admitted']}, "
                  f"weight {e['weight']}, its members' nr_samples sum to {want}")
    for cl in hier.clients:
        check(cl.rounds == list(range(R)), f"phase 13(a): client {cl.client_id} applied "
              f"rounds {cl.rounds}")
    for r in range(R):
        for cl in hier.clients[1:]:
            for key, value in hier.clients[0].states[r].items():
                check(bool((value == cl.states[r][key]).all()),
                      f"phase 13(a): {key} differs between clients 1 and {cl.client_id} "
                      f"after round {r}")
    first = max(float(np.max(np.abs(hier.averages[0][k] - flat.averages[0][k])))
                / max(float(np.max(np.abs(flat.averages[0][k]))), 1e-30)
                for k in flat.averages[0] if flat.averages[0][k].dtype.kind == "f")
    beta_err = np.abs(root.global_betas - flat.root.global_betas)
    past = int((beta_err > BETA_TOL).sum())
    print(f"hierarchy (a): the root's first average within {first:.3e} x max|.| of the flat "
          f"run's (bound 1e-6); final beta max |hierarchy - flat| {float(beta_err.max()):.3e} "
          f"(bound {BETA_TOL:g}), {past} of {beta_err.size} entries past it", flush=True)
    check(first <= 1e-6, f"phase 13(a): first average {first:.3e} x max|.| from the flat run's")
    if past:
        # Adam's sign flips can carry rounding past the bound, as in phase 6:
        # hold the hierarchy's spread to that of a witness whose only
        # difference from the flat run is the mean's association (the
        # clients in the reverse order, so the sum runs the other way).
        witness = Federation13("a-witness", clients_raw[::-1], num_epochs=HIER_FLAT_EPOCHS)
        witness.run()
        witness.check_leaves(notes)
        check(witness.root.global_iterations == R, "phase 13(a): witness rounds")
        w_max, w_frac = beta_spread(witness.root.global_betas, flat.root.global_betas, BETA_TOL)
        h_max, h_frac = beta_spread(root.global_betas, flat.root.global_betas, BETA_TOL)
        max_limit, frac_limit = max(4.0 * root.template.lr, 1.5 * w_max), 1.5 * w_frac + 1e-4
        print(f"hierarchy (a): past {BETA_TOL:g} the witness (flat, clients reversed) has "
              f"{w_frac:.6f} of beta's entries, max {w_max:.3e}; the hierarchy {h_frac:.6f}, "
              f"max {h_max:.3e} (limits {frac_limit:.6f}, {max_limit:.3e})", flush=True)
        check(h_max <= max_limit and h_frac <= frac_limit,
              f"phase 13(a): hierarchy beta spread {h_max:.3e}, {h_frac:.6f} past the "
              f"witness's limits {max_limit:.3e}, {frac_limit:.6f}")
    first_batch_kernels("hierarchy (a)", root._setup_reply, hier.clients[0], hier.kw)
    check_profiler("a", prof, hier.logs[0])

    def med(pairs, skip):
        return float(np.median(_seconds(pairs[skip:]))) * 1e3 if len(pairs) > skip else float("nan")

    def span_ms(logs, name):
        spans = [r for log in logs for r in log.events("span") if r["name"] == name
                 and r.get("round", 0) >= 1]
        return float(np.median([r["seconds"] for r in spans])) * 1e3 if spans else float("nan")

    def rounds(fed):
        out = sorted((r for r in fed.root_log.events("span") if r["name"] == "round"),
                     key=lambda r: r["round"])
        return out[1:]

    relay_logs = [hier.relay_logs[rid][0] for rid in HIER_RELAYS]
    h_rounds, f_rounds = rounds(hier), rounds(flat)
    h_ms = float(np.median([r["seconds"] for r in h_rounds])) * 1e3
    f_ms = float(np.median([r["seconds"] for r in f_rounds])) * 1e3
    n = len(HIER_RELAYS)
    print(f"hierarchy (a) ms per root round, {card}: median over rounds 2-{R}: {h_ms:.3f} "
          f"(flat: {f_ms:.3f} per global step); split, per relay: relay fan-out (the members' "
          f"steps, snapshots, encodes and transfer) {span_ms(relay_logs, 'relay_fanout'):.3f}, "
          f"relay decode and gate {med(relay_times['decode and gate'], n):.3f}, pre-reduction "
          f"{med(relay_times['pre-reduction'], n):.3f}, upstream encode "
          f"{med(relay_times['upstream encode'], n):.3f}; root decode and gate "
          f"{med(hier.times['root decode'], 1):.3f}, root mean "
          f"{med(hier.times['root mean'], 1):.3f}, relay re-broadcast (decode of the root's "
          f"push, per-member encode, members' set) {span_ms(relay_logs, 'relay_push'):.3f}",
          flush=True)
    h_bytes = [r["bytes_pulled"] + r["bytes_pushed"] for r in h_rounds]
    f_bytes = [r["bytes_pulled"] + r["bytes_pushed"] for r in f_rounds]
    print(f"hierarchy (a) bytes per round at the root, {card}: hierarchy "
          f"{float(np.median(h_bytes)) / 1e6:.3f} MB (2 relays), flat "
          f"{float(np.median(f_bytes)) / 1e6:.3f} MB (4 clients)", flush=True)


def relay_crash_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 13(b): the delta codec, ``relay_grace_rounds=2`` on the root and
    a ``save_dir`` on each relay; relay 101 aborted once the root has pushed
    ``RELAY_KILL_AFTER`` rounds and respawned on its address and
    ``save_dir``, its members back by session token; the root carries
    ``RoundProfiler(dir, "1:2")``."""
    from gfedntm_tpu_torch.utils.observability import RoundProfiler

    live = dict(liveness_timeout=HIER_LIVENESS_S, watchdog_poll_s=0.1, reconnect_window=120.0,
                wire_codec="delta")
    prof = RoundProfiler(str(SCRATCH / "profile_b"), "1:2")
    fed = Federation13("b", clients_raw, shards={HIER_RELAYS[0]: (1, 2), HIER_RELAYS[1]: (3, 4)},
                       root_kw=dict(relay_grace_rounds=2, wire_codec="delta", profiler=prof,
                                    max_iters=HIER_CRASH_ROUNDS,
                                    probation_rounds=HIER_PROBATION),
                       client_kw={c: live for c in (1, 2, 3, 4)}, journaled=True)
    prof.metrics = fed.root_log
    rid = HIER_RELAYS[0]
    state = {}

    reg = fed.root_log.registry

    def tick():
        if "killed" in state:
            # The respawn waits for the grace to expire (the root counting
            # live shards only), so the rounds over relay 102 alone happen
            # whatever a round costs.
            if "respawn" not in state and (
                    reg.gauge("live_shards").value == 1
                    or fed.root.global_iterations >= state["round"] + 3):
                respawn()
            return
        if fed.root.global_iterations < RELAY_KILL_AFTER:
            return
        victim = fed.relays[rid][0]
        victim.abort()
        # A real kill takes the relay's handler threads along: wait for the
        # one in flight (it holds the data-plane lock) before the respawn
        # reads the journal it may be writing.
        check(victim._lock.acquire(timeout=120), "phase 13(b): the aborted relay's "
              "round never ended")
        victim._lock.release()
        state["killed"] = victim._applied_round
        state["round"] = fed.root.global_iterations

    def respawn():
        state["respawn"] = time.perf_counter()
        state["respawn_round"] = fed.root.global_iterations
        fed.spawn(rid)
        respawned = fed.relays[rid][1]
        pre_reduce = respawned._pre_reduce

        def first_round(accepted):
            state.setdefault("first", time.perf_counter())
            return pre_reduce(accepted)

        respawned._pre_reduce = first_round

    run_s = fed.run(tick)
    check("respawn" in state, "phase 13(b): the relay was never killed and respawned")
    fed.check_leaves(notes, scheduled=False)
    respawned, log2 = fed.relays[rid][1], fed.relay_logs[rid][1]
    resets = [cid for cid, code in respawned.acks if code == 3]
    restored = sorted(e["client"] for e in log2.events("session_restored"))
    misses = (fed.counter(fed.logs, "codec_ref_miss") + reg.counter("codec_ref_miss").value
              + sum(fed.counter(logs, "codec_ref_miss") for logs in fed.relay_logs.values()))
    print(f"hierarchy (b), {card}: relay {rid} killed after root round "
          f"{RELAY_KILL_AFTER} (its last applied round {state['killed']}), respawned at root "
          f"round {state['respawn_round']} and recovered at round {respawned.resumed}; session "
          f"restores {restored}, Ack 3 resets to members {sorted(resets)}; the root saw "
          f"ready(recovered) "
          f"{[c for c, rec in fed.root_ready if rec]}; live_shards "
          f"{reg.gauge('live_shards').value}; codec_ref_miss {misses}; "
          f"{fed.root.global_iterations} rounds in {run_s:.2f} s; local steps "
          f"{[len(cl.steps) for cl in fed.clients]}; members' liveness window "
          f"{HIER_LIVENESS_S:g} s (their inter-poll gap EWMAs "
          f"{[round(cl._gap_ewma or 0.0, 3) for cl in fed.clients]} s); respawn to the first "
          f"recovered round {state.get('first', float('nan')) - state['respawn']:.3f} s",
          flush=True)
    check(respawned.resumed is not None and respawned.resumed >= state["killed"] - 2,
          f"phase 13(b): recovered at {respawned.resumed}, killed at {state['killed']}")
    # A member whose idle gap outlasts its window reconnects with no cause
    # (restored, Ack 0): only the two restores after the crash reset codecs.
    check(sorted(resets) == [1, 2] and len(restored) >= 2 and set(restored) == {1, 2},
          f"phase 13(b): session restores {restored} and Ack 3 resets {resets} at the "
          "respawned relay")
    check((rid, True) in fed.root_ready, "phase 13(b): the root never saw recovered=True")
    check("first" in state, "phase 13(b): the respawned relay never answered a round")
    check(reg.gauge("live_shards").value == 1, "phase 13(b): live_shards")
    pre = {r: [e["round"] for e in logs[0].events("relay_preaggregated")]
           for r, logs in fed.relay_logs.items()}
    alone = sorted(set(pre[HIER_RELAYS[1]]) - set(pre[rid])
                   - {e["round"] for e in log2.events("relay_preaggregated")})
    print(f"hierarchy (b): rounds over relay {HIER_RELAYS[1]} alone {alone}", flush=True)
    check(len(alone) >= 1, "phase 13(b): no round went on over the live shard alone")
    check(misses == 0, "phase 13(b): codec_ref_miss")
    check_profiler("b", prof, fed.root_log)


def relay_loss_phase(card: str, notes: dict, clients_raw) -> None:
    """Phase 13(c): relay 102 aborted once the root has pushed
    ``RELAY_LOSS_AFTER`` rounds and never respawned; its members carry
    ``failover_addrs=[root]`` and re-home there."""
    short = dict(liveness_timeout=DOOMED_LIVENESS_S, watchdog_poll_s=0.1,
                 reconnect_window=DOOMED_RECONNECT_S)
    fed = Federation13("c", clients_raw, shards={HIER_RELAYS[0]: (1, 2), HIER_RELAYS[1]: (3, 4)},
                       root_kw=dict(max_iters=HIER_LOSS_ROUNDS),
                       client_kw={c: short for c in (3, 4)})
    for cl in fed.clients[2:]:
        cl.failover_addrs = [fed.root_address]
    rid = HIER_RELAYS[1]
    state = {}

    def tick():
        if "killed" not in state and fed.root.global_iterations >= RELAY_LOSS_AFTER:
            fed.relays[rid][0].abort()
            state["killed"] = time.perf_counter()

    run_s = fed.run(tick)
    check("killed" in state, "phase 13(c): the relay was never killed")
    fed.check_leaves(notes, scheduled=False)
    from gfedntm_tpu_torch.federation.registry import DROPPED

    rehomes = [log.registry.counter("client_rehomes").value for log in fed.logs]
    # A re-homed member whose idle gap at the root outlasts its tight window
    # reconnects again, and the root, which minted it no token, logs it
    # re-homed again: count the members.
    rehomed = sorted(e["client"] for e in fed.root_log.events("member_rehomed"))
    live = sorted(c.client_id for c in fed.root.federation.get_clients() if c.status != DROPPED)
    print(f"hierarchy (c), {card}: relay {rid} killed after root round {RELAY_LOSS_AFTER}; "
          f"client_rehomes per client {rehomes}; the root's member_rehomed {rehomed}; its live "
          f"membership {live}; {fed.root.global_iterations} rounds in {run_s:.2f} s; local "
          f"steps {[len(cl.steps) for cl in fed.clients]}; members 3 and 4's liveness "
          f"window {DOOMED_LIVENESS_S:g} s, reconnect window {DOOMED_RECONNECT_S:g} s", flush=True)
    check(rehomes == [0, 0, 1, 1], f"phase 13(c): client_rehomes {rehomes}")
    check(sorted(set(rehomed)) == [3, 4], f"phase 13(c): member_rehomed {rehomed}")
    check(live == [3, 4, HIER_RELAYS[0]], f"phase 13(c): the root's live membership {live}")


def hierarchy_phase(card: str, notes: dict, clients_raw=None) -> None:
    """Phase 13: the relay tier and the round profiler with four port
    clients on the card."""
    t_phase = time.perf_counter()
    clients_raw = hierarchy_corpora(card, clients_raw)
    hierarchy_flat_phase(card, notes, clients_raw)
    relay_crash_phase(card, notes, clients_raw)
    relay_loss_phase(card, notes, clients_raw)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)



# ---------------------------------------------------------------------------
# Phase 14: the serving plane
# ---------------------------------------------------------------------------
SERVE_DOCS = 256  # 14(a): client 1's documents answered
SERVE_LOAD_S = 4.0  # 14(b): each closed loop's seconds
SERVE_CONCURRENCY = (1, 4, 16)  # 14(b): closed-loop workers
SERVE_REQUEST_DOCS = 4  # documents per request of 14(b) and 14(c)
SERVE_RESUME_STEPS = 3  # 14(c): global steps of the resumed federation
SERVE_BRIDGE_V = 5_000  # 14(d): the rmsprop federation's generator vocabulary


def serving_reference(pub, X, rows: int):
    """theta of ``X`` from ``get_theta(noise=0.0)`` of the port's template
    model with ``pub``'s average loaded through the weight bridge, in
    ``rows``-row chunks (the engine's largest bucket)."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import interop
    from gfedntm_tpu_torch.federation.server import build_template_model

    model = build_template_model(pub.family, len(pub.vocab), pub.model_kwargs)
    trees = {"params": {}, "batch_stats": {}}
    for key, value in pub.average.items():
        collection, *path = key.split("/")
        node = trees[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    _, unexpected = model.model.load_state_dict(
        interop.state_dict_from_flax(trees["params"], trees["batch_stats"]), strict=False)
    check(not unexpected, f"phase 14(a): the journal has keys the template lacks {unexpected}")
    out = []
    with torch.no_grad():
        for lo in range(0, len(X), rows):
            x = torch.from_numpy(X[lo:lo + rows]).to(model.device)
            out.append(model.model.get_theta(x, noise=0.0).cpu().numpy())
    return np.concatenate(out)


def serving_cold_phase(card: str, store: Path, clients_raw) -> None:
    """Phase 14(a) and (b): a ``ServingPlane`` on phase 9's store (V=66,001,
    K=50, H=(100, 100)): the cold load, theta for client 1's documents held
    against the template model's ``get_theta``, bucket invariance, the
    engine's ms per bucket beside the padded batch's copy to the card and
    the request's protobuf work, and closed loops over gRPC; no launch of
    K1-K3 from the load to the end of the loops."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.data.vocab import Vocabulary, vectorize
    from gfedntm_tpu_torch.federation import codec
    from gfedntm_tpu_torch.federation.protos import federated_pb2 as pb
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.serving import ClosedLoopLoadGen, ServingPlane, make_infer_stub
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    log = MetricsLogger(node="serve", keep_records=True)
    fd.reset_launches()
    t0 = time.perf_counter()
    plane = ServingPlane(str(store), max_batch=64, poll_s=0.2, metrics=log, ops_port=0)
    engine = plane.engine
    check(engine.device.type == "cuda", f"phase 14: the engine is on {engine.device}")
    plane.start("127.0.0.1:0")
    try:
        while not engine.ready:
            check(time.perf_counter() - t0 < 120, "phase 14(a): the plane never became ready")
            time.sleep(0.01)
        cold_s = time.perf_counter() - t0
        pub = plane.source.load()
        check(pub.round == engine.model_round, f"phase 14(a): serving round "
              f"{engine.model_round}, the store's newest {pub.round}")
        V, K = len(pub.vocab), int(pub.model_kwargs["n_components"])
        X = vectorize(clients_raw[0].documents[:SERVE_DOCS], Vocabulary(pub.vocab))
        theta, rnd = engine.infer(X)
        want = serving_reference(pub, X, engine.max_batch)
        check(theta.shape == (SERVE_DOCS, K) and theta.dtype == np.float32,
              f"phase 14(a): theta {theta.shape} {theta.dtype}")
        check(np.array_equal(theta, want), "phase 14(a): theta differs from get_theta(noise=0.0) "
              f"of the template with the journal's average by "
              f"{float(np.abs(theta - want).max()):.3e}")
        per_size = {}
        for size in (1, 3, 17):
            parts = [engine.infer(X[lo:lo + size])[0] for lo in range(0, SERVE_DOCS, size)]
            per_size[size] = float(np.abs(np.concatenate(parts) - theta).max())
        stochastic = float(np.abs(theta.astype(np.float64).sum(1) - 1.0).max())
        print(f"serving (a), {card}: cold load of round {rnd} ({pub.source}, V={V}, K={K}) to "
              f"ready in {cold_s:.3f} s; theta of {SERVE_DOCS} documents of client 1 in "
              f"{engine.max_batch}-row requests bitwise equal to get_theta(noise=0.0) of the "
              f"template with the journal's average; max |diff| against 1-, 3- and 17-row "
              f"requests {per_size} (limit 1e-6); max |row sum - 1| {stochastic:.2e}",
              flush=True)
        check(max(per_size.values()) <= 1e-6, f"phase 14(a): bucket sizes differ {per_size}")
        check(stochastic <= 1e-5, f"phase 14(a): rows sum to 1 within {stochastic:.2e}")

        # (b) ms per engine.infer per bucket, beside the padded batch's copy
        # to the card and a request's protobuf work at that bucket.
        parts = []
        for bucket in engine.buckets:
            x = np.ascontiguousarray(X[:bucket])
            infer_ms = time_ms(lambda: engine.infer(x))
            copy_ms = time_ms(lambda: torch.from_numpy(x).to(engine.device))
            req = pb.InferRequest(request_id=1)
            req.bow.tensors.append(codec.array_to_record("bow", x))
            data = req.SerializeToString()
            t1 = time.perf_counter()
            for _ in range(5):
                codec.record_to_array(pb.InferRequest.FromString(data).bow.tensors[0])
            decode_ms = (time.perf_counter() - t1) / 5 * 1e3
            parts.append(f"{bucket}: {infer_ms:.3f} (copy {copy_ms:.3f}, request parse and "
                         f"decode {decode_ms:.3f} of {len(data) / 1e6:.2f} MB)")
        print(f"serving (b) engine.infer ms per bucket, {card}: median of 20 after 3 warm-ups, "
              + "; ".join(parts), flush=True)
        stub = make_infer_stub(f"127.0.0.1:{plane.bound_port}")
        rngs = [np.random.default_rng(14 + i) for i in range(max(SERVE_CONCURRENCY))]

        def make_batch(worker, seq):
            lo = int(rngs[worker].integers(0, SERVE_DOCS - SERVE_REQUEST_DOCS))
            return X[lo:lo + SERVE_REQUEST_DOCS]

        fill = log.registry.histogram("serve_batch_fill", buckets=(0.125, 0.25, 0.5, 0.75, 0.9,
                                                                   1.0))
        loops = []
        try:
            for conc in SERVE_CONCURRENCY:
                n0, s0 = fill.count, fill.sum
                summary = ClosedLoopLoadGen(stub, make_batch, concurrency=conc,
                                            duration_s=SERVE_LOAD_S).run()
                check(summary["failures"] == 0 and summary["requests"] > 0,
                      f"phase 14(b): {summary['failures']} failed requests at concurrency "
                      f"{conc}: {summary['failure_samples']}")
                mean_fill = (fill.sum - s0) / max(fill.count - n0, 1)
                loops.append(f"{conc}: p50 {summary['p50_ms']:.3f} p99 {summary['p99_ms']:.3f} "
                             f"ms, {summary['docs_per_s']:.1f} docs/s, {summary['requests']} "
                             f"requests, mean batch fill {mean_fill:.3f} in "
                             f"{(fill.count - n0)} batches")
        finally:
            stub.channel.close()
        print(f"serving (b) closed loops over gRPC Infer, {card}: {SERVE_REQUEST_DOCS}-document "
              f"requests, {SERVE_LOAD_S:g} s each; by concurrency " + "; ".join(loops),
              flush=True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in fd.LAUNCHES.items() if k in ("stats", "loss", "grads")}
        check(not any(launches.values()), f"phase 14(a)-(b): the serving path launched {launches}")
        print(f"serving (a)-(b): launches of K1-K3 from the load to the end of the loops "
              f"{launches}", flush=True)
    finally:
        plane.stop()


def serving_swap_phase(card: str, notes: dict, store: Path, clients_raw) -> None:
    """Phase 14(c): a copy of phase 9's store resumed by a port server that
    autorecovers from its journal, with phase 9's two clients, for
    :data:`SERVE_RESUME_STEPS` more global steps, while a ``ServingPlane``
    polls the copy every 0.2 s under closed-loop gRPC load at concurrency 4:
    at least two swaps, no failed request, no worker's model round going
    back; then a journaled round flagged by the quality guard is refused and
    the plane keeps serving the round before it."""
    import json
    import threading

    import numpy as np
    import torch

    from gfedntm_tpu_torch.data.vocab import Vocabulary, vectorize
    from gfedntm_tpu_torch.federation.server import FederatedServer
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.serving import ClosedLoopLoadGen, ServingPlane, make_infer_stub
    from gfedntm_tpu_torch.train.checkpoint import RoundJournal, atomic_write_json
    from gfedntm_tpu_torch.utils.observability import MetricsLogger

    copy = SCRATCH / "serving"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(store, copy)
    journal = copy / "checkpoints" / RoundJournal.META_NAME
    meta = json.loads(journal.read_text())
    meta.pop("finished", None)  # phase 9 stopped cleanly: resume it as if it had been killed
    atomic_write_json(str(journal), meta)
    last = int(meta["round"])
    kw = dict(meta["model_kwargs"])
    log = MetricsLogger(node="serve", keep_records=True)
    plane = ServingPlane(str(copy), max_batch=64, poll_s=0.2, metrics=log)
    plane.start("127.0.0.1:0")
    server = None
    clients = []
    try:
        t0 = time.perf_counter()
        while not plane.engine.ready:
            check(time.perf_counter() - t0 < 120, "phase 14(c): the plane never became ready")
            time.sleep(0.01)
        check(plane.engine.model_round == last, f"phase 14(c): serving round "
              f"{plane.engine.model_round}, the copy's journal {last}")
        X = vectorize(clients_raw[0].documents[:SERVE_DOCS], Vocabulary(plane.engine.vocab))
        server_log = MetricsLogger(node="server", keep_records=True)
        server = FederatedServer(min_clients=len(clients_raw), family="avitm", model_kwargs=kw,
                                 max_iters=last + 1 + SERVE_RESUME_STEPS, save_dir=str(copy),
                                 metrics=server_log)
        resumed = server.maybe_autorecover()
        check(resumed == last + 1, f"phase 14(c): resumed at {resumed}, want {last + 1}")
        address = server.start("127.0.0.1:0")
        Recorded = recorded_client()
        clients = [Recorded(client_id=c + 1, corpus=corpus, server_address=address,
                            listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                            max_features=None) for c, corpus in enumerate(clients_raw)]
        stub = make_infer_stub(f"127.0.0.1:{plane.bound_port}")
        seen: dict[int, list] = {}
        rngs = [np.random.default_rng(40 + i) for i in range(4)]

        def infer(x):
            theta, rnd = stub(x)
            seen.setdefault(threading.get_ident(), []).append(rnd)
            return theta, rnd

        def make_batch(worker, seq):
            lo = int(rngs[worker].integers(0, SERVE_DOCS - SERVE_REQUEST_DOCS))
            return X[lo:lo + SERVE_REQUEST_DOCS]

        # The load ends once it has answered from three rounds (two swaps).
        gen = ClosedLoopLoadGen(infer, make_batch, concurrency=4, duration_s=1.0,
                                min_rounds=3, max_duration_s=120.0)
        out: dict = {}
        loader = threading.Thread(target=lambda: out.update(gen.run()), daemon=True)
        fd.reset_launches()
        loader.start()
        run_s = run_clients(clients, server, "phase 14(c)")
        torch.cuda.synchronize()
        launches = {k: v for k, v in fd.LAUNCHES.items() if k in ("stats", "loss", "grads")}
        loader.join(timeout=300)
        stub.channel.close()
        check(not loader.is_alive() and out, "phase 14(c): the load generator did not end")
        swaps = log.events("serve_model_swapped")
        steps = sum(len(cl.steps) for cl in clients)
        print(f"serving (c), {card}: phase 9's store resumed at round {resumed} from the "
              f"{server._recovered_source}; {server.global_iterations - resumed} global steps in "
              f"{run_s:.2f} s while the plane served {out['requests']} requests at concurrency 4 "
              f"({out['failures']} failed, p50 {out['p50_ms']:.3f} p99 {out['p99_ms']:.3f} ms, "
              f"{out['docs_per_s']:.1f} docs/s); rounds answered {out['model_rounds_seen']}; "
              f"swaps {[(e['prev_round'], e['round']) for e in swaps]}; local steps {steps}; "
              f"launches {launches}", flush=True)
        check(out["failures"] == 0, f"phase 14(c): failed requests {out['failure_samples']}")
        check(len(swaps) >= 2 and len(out["model_rounds_seen"]) >= 3,
              f"phase 14(c): {len(swaps)} swaps, the load saw {out['model_rounds_seen']}")
        check(all(r == sorted(r) for r in seen.values()),
              "phase 14(c): a worker saw a model round go back")
        check(server.global_iterations == last + 1 + SERVE_RESUME_STEPS,
              f"phase 14(c): the resumed federation ended at round {server.global_iterations}")
        for name in ("stats", "loss", "grads"):
            check(launches[name] == steps, f"phase 14(c): {name} launched {launches[name]} "
                  f"times, the clients took {steps} local steps")
            notes[name] += f"; phase 14(c) resumed federation under serving load: " \
                           f"{launches[name]} launches"
        first_batch_kernels("serving (c)", server._setup_reply, clients[0], kw)

        # A round the quality guard flagged is refused; the plane keeps the
        # round before it.
        last = server.global_iterations - 1
        while plane.engine.model_round != last:
            check(time.perf_counter() - t0 < 600, f"phase 14(c): round {last} never served")
            time.sleep(0.05)
        kept = plane.engine.model_round
        state = RoundJournal(str(copy / "checkpoints")).load(include_finished=True)
        extra = {k: v for k, v in state.items() if k not in (
            "round", "average", "aggregator_state", "membership", "vocab", "average_keys",
            "finished")}
        extra["quality"] = {"flagged": True, "unhealthy_streak": 3}
        RoundJournal(str(copy / "checkpoints")).record(
            kept + 1, state["average"], state["membership"], vocab=state["vocab"], extra=extra)
        refused = log.registry.counter("serving_swaps_refused")
        while refused.value < 1:
            check(time.perf_counter() - t0 < 600, "phase 14(c): the flagged round was never read")
            time.sleep(0.05)
        theta, rnd = plane.batcher.submit(X[:SERVE_REQUEST_DOCS]).result(timeout=30)
        print(f"serving (c): round {kept + 1} journaled with quality.flagged refused "
              f"(serving_swaps_refused {refused.value:g}); still serving round {rnd}", flush=True)
        check(refused.value == 1 and plane.engine.model_round == kept and rnd == kept,
              f"phase 14(c): serving round {plane.engine.model_round} after the flagged round")
    finally:
        plane.stop()
        if server is not None:
            server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)


def serving_bridge_phase(card: str) -> None:
    """Phase 14(d): a port-only gRPC federation with ``solver="rmsprop"``,
    2 clients, 2 global steps, from a generator vocabulary of
    :data:`SERVE_BRIDGE_V` words: the join carries rmsprop's optax state,
    each client's momentum buffers equal what the bridge loads from the
    GlobalSetup, the losses are finite and the shared state is bitwise
    equal across the clients."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch import RawCorpus, generate_synthetic_corpus
    from gfedntm_tpu_torch.federation import codec
    from gfedntm_tpu_torch.federation.client import load_global_setup
    from gfedntm_tpu_torch.federation.server import (
        FederatedServer,
        build_template_model,
        model_opt_state,
    )
    from gfedntm_tpu_torch.train.optimizers import RMSprop

    corpus = generate_synthetic_corpus(vocab_size=SERVE_BRIDGE_V, n_topics=50, n_docs=1024,
                                       n_nodes=2, materialize_docs=True, seed=3)
    clients_raw = [RawCorpus(documents=node.documents) for node in corpus.nodes]
    kw = dict(n_components=50, hidden_sizes=(100, 100), batch_size=256, num_epochs=2, seed=0,
              solver="rmsprop")
    save_dir = SCRATCH / "serving_rmsprop"
    shutil.rmtree(save_dir, ignore_errors=True)
    Recorded = recorded_client()

    class Joined(Recorded):
        def join_federation(self):
            super().join_federation()
            model = self.stepper.model
            self.joined_bytes = codec.tree_to_bundle(model_opt_state(model)).SerializeToString()
            self.joined_buffers = {
                n: model.optimizer.state[p]["momentum_buffer"].clone()
                for n, p in model.model.named_parameters()}

    server = FederatedServer(min_clients=2, family="avitm", model_kwargs=kw, max_iters=2,
                             save_dir=str(save_dir))
    address = server.start("127.0.0.1:0")
    clients = [Joined(client_id=c + 1, corpus=corpus_c, server_address=address,
                      listen_address="127.0.0.1:0", advertise_host="127.0.0.1",
                      max_features=None) for c, corpus_c in enumerate(clients_raw)]
    try:
        run_s = run_clients(clients, server, "phase 14(d)")
    finally:
        server.stop(grace=0.5, join_timeout=30)
        for cl in clients:
            cl.shutdown(grace=0.5)
    setup = server._setup_reply
    V = len(setup.vocab)
    bridged = build_template_model("avitm", V, kw)
    load_global_setup(bridged, setup)
    losses = [cl.losses for cl in clients]
    print(f"serving (d), {card}: a port federation with solver='rmsprop' at V={V}: "
          f"{server.global_iterations} global steps in {run_s:.2f} s; losses {losses}; "
          f"optimizer {type(clients[0].stepper.model.optimizer).__name__}; init_opt_state "
          f"{len(setup.init_opt_state.tensors)} records, {setup.init_opt_state.ByteSize() / 1e6:.2f} "
          f"MB", flush=True)
    check(server.global_iterations == 2, f"phase 14(d): {server.global_iterations} global steps")
    check(all(len(l) == 2 and bool(np.isfinite(l).all()) for l in losses),
          f"phase 14(d): losses {losses}")
    for cl in clients:
        check(isinstance(cl.stepper.model.optimizer, RMSprop),
              f"phase 14(d): client {cl.client_id} steps with "
              f"{type(cl.stepper.model.optimizer).__name__}")
        check(cl.joined_bytes == setup.init_opt_state.SerializeToString(),
              f"phase 14(d): client {cl.client_id}'s optimizer state is not the setup's")
        for name, p in bridged.model.named_parameters():
            check(torch.equal(cl.joined_buffers[name],
                              bridged.optimizer.state[p]["momentum_buffer"]),
                  f"phase 14(d): client {cl.client_id}'s {name} momentum buffer differs from "
                  "the bridge's")
    for step in range(2):
        for key, value in clients[0].states[step].items():
            check(torch.equal(value, clients[1].states[step][key]),
                  f"phase 14(d): {key} differs across clients after aggregate {step + 1}")


def serving_phase(card: str, notes: dict, raw=None, phase9=None) -> None:
    """Phase 14: the serving plane on phase 9's store and corpora (phase 9
    runs first when it has not, as under ``--serving-only``)."""
    t_phase = time.perf_counter()
    raw = raw or raw_text_corpora(card)
    if phase9 is None:
        federation_phase(card, notes, raw)
    store = SCRATCH / "federation"
    check((store / "checkpoints" / "journal.json").exists(), "phase 14: phase 9 left no journal")
    t0 = time.perf_counter()
    serving_cold_phase(card, store, raw[0])
    serving_swap_phase(card, notes, store, raw[0])
    serving_bridge_phase(card)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s ({card}; "
          f"{time.perf_counter() - t_phase:.1f} s with what it ran first)", flush=True)


# ---------------------------------------------------------------------------
# Phase 15: the command line, one process per node
# ---------------------------------------------------------------------------
#: Where phase 15 writes its archive, INI, save dirs and process logs;
#: ``main`` removes it.
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
#: Each phase 15 process's own limit, in seconds.
CLI_LIMIT_S = {"simulate": 120.0, "server": 150.0, "client": 150.0, "serve": 90.0,
               "mesh server": 240.0, "mesh client": 240.0}
#: 15(b)'s server: global steps (1,024 documents a client, B=256, 2 epochs).
CLI_STEPS = 8
#: 15(c): Infer requests of CLI_REQUEST_DOCS documents each, and the serve
#: process's ``--serve_duration`` (seconds after its plane starts), a backstop:
#: the phase ends the process with SIGINT once its requests are answered. On
#: an H100 host the plane turned ready 6 s to over 8 s after it started when
#: alone, and 13-23 s after beside other processes' starts: the model modules'
#: first import (with torch.distributed's), the CUDA context, the journal's
#: load and the warm-up.
CLI_REQUESTS, CLI_REQUEST_DOCS, CLI_SERVE_S = 16, 4, 40.0
CLI_INI = """\
[ntms]
n_components = 50
hidden_sizes = (100, 100)
batch_size = 256
num_epochs = 2

[data]
max_features = 100000
"""


class CliProcess:
    """One ``python -m gfedntm_tpu_torch`` process of phase 15, its output
    in a log file under :data:`CLI_DIR` and its own time limit."""

    def __init__(self, name: str, argv: list, limit_s: float):
        self.name, self.limit_s = name, limit_s
        self.log = CLI_DIR / "logs" / f"{name}.log"
        self.log.parent.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parent)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        self.started = time.perf_counter()
        with self.log.open("w") as fh:
            self.proc = subprocess.Popen([sys.executable, "-m", "gfedntm_tpu_torch", *argv],
                                         cwd=CLI_DIR, env=env, stdout=fh,
                                         stderr=subprocess.STDOUT)

    def finish(self) -> float:
        """Wait within the process's own limit (killed past it); fail unless
        it exits 0. Returns its wall seconds."""
        left = self.limit_s - (time.perf_counter() - self.started)
        try:
            code = self.proc.wait(max(left, 0.1))
        except subprocess.TimeoutExpired:
            self.stop()
            code = f"killed at its {self.limit_s:g} s limit"
        seconds = time.perf_counter() - self.started
        if code != 0:
            tail = self.log.read_text()[-3000:]
            check(False, f"phase 15: {self.name} exited {code} after {seconds:.1f} s; its "
                         f"output ends:\n{tail}")
        return seconds

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def free_ports(n: int) -> list:
    """``n`` distinct free ports: all bound at once, then released."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def wait_for_port(port: int, proc: CliProcess, what: str) -> float:
    """Seconds until something listens on ``port`` (the server or the
    plane up): clients start only then, as an operator starts them."""
    import socket

    while True:
        check(proc.proc.poll() is None, f"phase 15: {proc.name} exited before {what}; "
              f"output:\n{proc.log.read_text()[-3000:]}")
        check(time.perf_counter() - proc.started < proc.limit_s,
              f"phase 15: no {what} within {proc.limit_s:g} s")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return time.perf_counter() - proc.started
        except OSError:
            time.sleep(0.2)


def jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def last_snapshot(records: list) -> dict:
    snaps = [r["metrics"] for r in records if r.get("event") == "metrics_snapshot"]
    return snaps[-1] if snaps else {}


def cli_simulate_phase(card: str, corpus, archive: Path, ini: Path, result, meanwhile):
    """15(a): ``simulate`` of phase 3's corpus from its archive and an INI,
    in a process of its own, with ``meanwhile()`` (15(b)) run while it
    works; the global betas bitwise phase 3's float32 fit's (``result``; run
    here when ``None``). Returns what ``meanwhile()`` returned."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer

    V, K, B = 100_000, 50, 256
    idx2token = {i: f"wd{i}" for i in range(V)}
    datasets = [BowDataset(X=node.bow, idx2token=idx2token) for node in corpus.nodes]

    def template():
        return AVITM(input_size=V, n_components=K, hidden_sizes=(100, 100), batch_size=B,
                     num_epochs=2)

    if result is None:  # --cli-only: phase 3's float32 fit, in this process
        result = FederatedTrainer(template(), n_clients=2).fit(datasets)
    want = FederatedTrainer(template(), n_clients=2).make_global_model(result)
    want = want.get_topic_word_distribution()

    save = CLI_DIR / "simulate"
    proc = CliProcess("simulate", ["--source", str(archive), "--config", str(ini),
                                   "--save_dir", str(save)], CLI_LIMIT_S["simulate"])
    try:
        out = meanwhile()
        wall = proc.finish()
    finally:
        proc.stop()
    summary = {}
    for line in proc.log.read_text().splitlines():  # stdout and stderr: the JSON line
        if line.startswith("{") and '"n_clients"' in line:
            summary = json.loads(line)
    check(bool(summary), "phase 15(a): no summary line")
    records = jsonl(save / "metrics.jsonl")
    fit_s = [r["seconds"] for r in records
             if r.get("event") == "phase" and r.get("phase") == "federated_fit"]
    # The trainer sets its docs_per_s gauge from a steady segment, one whose
    # length ran before; simulate fits in one segment, so the gauge is unset
    # and the fit's documents over its phase seconds stand beside it.
    docs = last_snapshot(records).get("docs_per_s", {}).get("value")
    fit_docs = 2 * CLI_STEPS * B / fit_s[0] if len(fit_s) == 1 else float("nan")
    with np.load(save / "global_model.npz") as z:
        got = z["betas"]
    diff = float(np.abs(got.astype(np.float64) - want).max()) if got.shape == want.shape \
        else float("inf")
    gauge = "unset (one segment)" if docs is None else f"{docs:.1f}"
    # Which of (b)'s rounds it overlapped: its stream's last record against
    # the start of each round of (b)'s server.
    ended = max(r["time"] for r in records)
    rounds = sorted((r for r in jsonl(CLI_DIR / "fed" / "metrics.jsonl")
                     if r.get("event") == "span" and r.get("name") == "round"),
                    key=lambda r: r["round"])
    overlapped = [r["round"] for r in rounds if r["time"] - r["seconds"] < ended]
    print(f"cli (a) simulate, {card}: exit 0 in {wall:.1f} s of wall time, beside (b)'s "
          f"start-up ((b)'s rounds begun before its last record: {overlapped}; (b)'s steady "
          f"median reads rounds 2-{CLI_STEPS}) (the process's start, the archive's load at "
          f"V={V}, the fit, the MC thetas of each client's documents); federated_fit phase {fit_s[0] if fit_s else float('nan'):.3f} s, "
          f"{fit_docs:.1f} docs/s over it (first step included); docs_per_s gauge {gauge}; "
          f"summary {summary}; global betas vs phase 3's in-process float32 fit: bitwise "
          f"{bool(np.array_equal(got, want))} (max |diff| {diff:.3e})", flush=True)
    check(summary["n_clients"] == 2 and summary["vocab_size"] == V
          and summary["global_steps"] == CLI_STEPS, f"phase 15(a): summary {summary}")
    check(math.isfinite(summary["final_mean_loss"]) and math.isfinite(summary["tss"])
          and 0 < summary["tss"] <= K, f"phase 15(a): loss or tss in {summary}")
    check(len(fit_s) == 1, f"phase 15(a): federated_fit phases {fit_s}")
    check(got.dtype == want.dtype and np.array_equal(got, want),
          f"phase 15(a): the CLI's global betas differ from phase 3's fit by {diff:.3e}")
    return out


def cli_federation_phase(card: str, archive: Path, ini: Path) -> tuple:
    """15(b): a server and two clients, each a process of its own on the
    card; then the readers over their streams. Returns the save dir and the
    last round the server journaled."""
    import contextlib
    import io

    import numpy as np

    from gfedntm_tpu_torch import cli
    from gfedntm_tpu_torch.serving import ModelSource

    fed, prof = CLI_DIR / "fed", CLI_DIR / "prof"
    port, *client_ports = free_ports(3)
    common = ["--config", str(ini), "--save_dir", str(fed)]
    server = CliProcess("server", ["--id", "0", "--min_clients_federation", "2",
                                   "--max_iters", str(CLI_STEPS), "--listen_port", str(port)]
                        + common, CLI_LIMIT_S["server"])
    procs = [server]
    try:
        up = wait_for_port(port, server, "server listening")
        for c in (1, 2):
            extra = ["--profile_dir", str(prof), "--profile_rounds", "2:3"] if c == 1 else []
            procs.append(CliProcess(f"client{c}", [
                "--id", str(c), "--source", str(archive), "--server_address",
                f"localhost:{port}", "--listen_port", str(client_ports[c - 1])] + common + extra,
                CLI_LIMIT_S["client"]))
        walls = [p.finish() for p in procs]
    finally:
        for p in procs:
            p.stop()
    check((fed / "server_model.npz").is_file(), "phase 15(b): no server_model.npz")
    with np.load(fed / "client1" / "model.npz") as a, np.load(fed / "client2" / "model.npz") as b:
        same = a["betas"].shape == b["betas"].shape and bool(np.array_equal(a["betas"],
                                                                            b["betas"]))
        V = a["betas"].shape[1]
    check(same, "phase 15(b): the clients' saved betas differ")
    traces = sorted(prof.glob("*.pt.trace.json"))
    kernels = trace_kernels(traces[0]) if len(traces) == 1 else {}
    streams = [fed / "metrics.jsonl", fed / "client1" / "metrics.jsonl",
               fed / "client2" / "metrics.jsonl"]
    server_log = jsonl(streams[0])
    rounds = sorted((r for r in server_log if r.get("event") == "span"
                     and r.get("name") == "round"), key=lambda r: r["round"])
    steady = rounds[1:] or rounds
    ms = float(np.median([r["seconds"] for r in steady])) * 1e3
    up_b = float(np.median([r["bytes_pulled"] for r in steady]))
    down_b = float(np.median([r["bytes_pushed"] for r in steady]))
    phase9 = STEADY_MS.get("phase 9")
    STEADY_MS["phase 15"] = ms
    print(f"cli (b) wire federation, {card}: server, client 1 and client 2 in processes of "
          f"their own, each exit 0 (wall {', '.join(f'{w:.1f}' for w in walls)} s; the server "
          f"listened after {up:.1f} s); global V={V}, {len(rounds)} rounds; median ms per "
          f"global step over rounds 2-{len(rounds)} {ms:.3f} ({2 * 256 / ms * 1e3:.1f} docs/s; "
          f"phase 9, every node in one interpreter: "
          + (f"{phase9:.3f} ms this run)" if phase9 else "not run in this call)")
          + f"; bytes per step, up {up_b / 1e6:.3f} MB and down {down_b / 1e6:.3f} MB (2 "
          f"clients); client 1's trace {traces[0].name if traces else None} names "
          f"{kernels}", flush=True)
    check(len(rounds) == CLI_STEPS, f"phase 15(b): {len(rounds)} rounds, want {CLI_STEPS}")
    check(len(traces) == 1 and all(kernels.get(f, 0) > 0 for f in TENSOR_CORE_FAMILIES),
          f"phase 15(b): client 1's traces {traces} name kernels {kernels}")

    def reader(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        return rc, out.getvalue()

    rc, summary = reader(["summarize", *map(str, streams)])
    check(rc == 0 and "phase breakdown" in summary and "wire accounting per tier" in summary,
          f"phase 15(b): summarize rc {rc}:\n{summary[-2000:]}")
    merged = CLI_DIR / "trace.json"
    rc, text = reader(["trace", *map(str, streams), "-o", str(merged)])
    events = json.loads(merged.read_text())["traceEvents"] if merged.is_file() else []
    names = {e["pid"]: e["args"]["name"] for e in events if e.get("ph") == "M"}
    spans = {names.get(e["pid"]) for e in events if e.get("ph") == "X"}
    check(rc == 0 and spans == {"server", "client1", "client2"},
          f"phase 15(b): trace rc {rc}, spans of {spans}: {text}")
    rc, report = reader(["report", *map(str, streams)])
    check(rc == 0 and "model-quality report" in report, f"phase 15(b): report rc {rc}")
    print(f"cli (b) readers: summarize exit 0 ({len(summary.splitlines())} lines); trace exit "
          f"0: {text.strip()}; report exit 0 ({report.splitlines()[0]})", flush=True)
    newest = ModelSource(str(fed)).peek()
    check(newest is not None, "phase 15(b): nothing published in the server's save dir")
    return fed, newest[0], rounds[-1]["round"]


def cli_serve_phase(card: str, corpus, fed: Path, published: int, last_round: int) -> None:
    """15(c): ``--role serve`` on (b)'s save dir, in a process of its own:
    16 four-document ``Infer`` requests through ``make_infer_stub``."""
    import urllib.request

    import numpy as np

    from gfedntm_tpu_torch.data.vocab import Vocabulary, vectorize
    from gfedntm_tpu_torch.serving import ModelSource, make_infer_stub

    vocab = ModelSource(str(fed)).load().vocab
    n = CLI_REQUESTS * CLI_REQUEST_DOCS
    X = vectorize(corpus.nodes[0].documents[:n], Vocabulary(tuple(vocab)))
    port, ops = free_ports(2)
    proc = CliProcess("serve", ["--role", "serve", "--save_dir", str(fed), "--config",
                                str(CLI_DIR / "cli.cf"), "--listen_port", str(port),
                                "--ops_port", str(ops), "--serve_poll", "0.2",
                                "--serve_duration", f"{CLI_SERVE_S:g}", "--verbose"],
                      CLI_LIMIT_S["serve"])
    try:
        up = wait_for_port(ops, proc, "ops endpoint")
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{ops}/ready", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            alive = proc.proc.poll() is None
            check(alive and time.perf_counter() - proc.started < up + CLI_SERVE_S,
                  f"phase 15(c): the plane never turned ready (ops endpoint up after {up:.1f} "
                  f"s; the process {'running' if alive else 'exited'} after "
                  f"{time.perf_counter() - proc.started:.1f} s); its output ends:\n"
                  f"{proc.log.read_text()[-4000:]}")
            time.sleep(0.1)
        ready_s = time.perf_counter() - proc.started
        infer = make_infer_stub(f"127.0.0.1:{port}")
        failed, thetas, model_rounds, ms = 0, [], set(), []
        for i in range(CLI_REQUESTS):
            t0 = time.perf_counter()
            try:
                theta, model_round = infer(X[i * CLI_REQUEST_DOCS:(i + 1) * CLI_REQUEST_DOCS], i)
            except Exception as err:  # counted, and the phase fails below
                failed += 1
                print(f"cli (c): request {i} failed: {err!r}", flush=True)
                continue
            ms.append((time.perf_counter() - t0) * 1e3)
            thetas.append(theta)
            model_rounds.add(model_round)
        # The requests are answered: interrupt the plane (the serve role
        # drains and exits 0 on SIGINT) rather than wait out its duration.
        import signal

        proc.proc.send_signal(signal.SIGINT)
        wall = proc.finish()
    finally:
        proc.stop()
    theta = np.concatenate(thetas) if thetas else np.zeros((0, 1))
    row_err = float(np.abs(theta.sum(axis=1) - 1.0).max()) if thetas else float("inf")
    print(f"cli (c) serve, {card}: its ops endpoint up {up:.1f} s and the plane ready "
          f"{ready_s:.1f} s after its start (--serve_duration {CLI_SERVE_S:g}); {CLI_REQUESTS} "
          f"requests of {CLI_REQUEST_DOCS} documents at V={len(vocab)}, {failed} failed, "
          f"median {float(np.median(ms)) if ms else float('nan'):.3f} ms a request; theta "
          f"{theta.shape}, rows sum to 1 within {row_err:.2e}; model_round {sorted(model_rounds)}"
          f" (the store's newest {published}, the server's last round span {last_round}); exit 0 "
          f"after {wall:.1f} s", flush=True)
    check(failed == 0 and theta.shape == (n, 50), f"phase 15(c): {failed} failed requests, "
          f"theta {theta.shape}")
    check(row_err <= 1e-6, f"phase 15(c): theta rows sum to 1 within {row_err:.2e} (limit 1e-6)")
    check(model_rounds == {published}, f"phase 15(c): model_round {model_rounds}, the store's "
          f"newest {published}")


def cli_phase(card: str, result=None, start_mesh: bool = False):
    """Phase 15: (a) ``simulate`` beside (b)'s start-up (the processes'
    imports, the joins and the consensus, before the rounds whose median
    (b) reads), then (c) the serving plane alone, every node a ``python -m
    gfedntm_tpu_torch`` process on the card; phase 3's float32 fit is
    ``result`` (run in (a) when ``None``). With ``start_mesh``, 17(b)'s
    processes (:class:`MeshFederation`) start once the archive is written
    and run beside (a)-(c); they are returned, running."""
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus, save_reference_npz

    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    corpus = generate_synthetic_corpus(vocab_size=100_000, n_topics=50, n_docs=1024, n_nodes=2,
                                       materialize_docs=True, seed=0)
    archive, ini = CLI_DIR / "corpus.npz", CLI_DIR / "cli.cf"
    save_reference_npz(corpus, str(archive))
    ini.write_text(CLI_INI)
    print(f"cli: phase 3's corpus as a reference archive ({archive.stat().st_size / 1e6:.1f} "
          f"MB) in {time.perf_counter() - t0:.1f} s", flush=True)
    federation = MeshFederation(archive, ini).start() if start_mesh else None
    try:
        fed, published, last_round = cli_simulate_phase(
            card, corpus, archive, ini, result, lambda: cli_federation_phase(card, archive, ini))
        cli_serve_phase(card, corpus, fed, published, last_round)
    except BaseException:
        if federation is not None:
            federation.stop()
        raise
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s ({card})"
          + (", 17(b)'s processes beside it" if start_mesh else ""), flush=True)
    return federation


# ---------------------------------------------------------------------------
# Phase 16: the scenario matrix's headline composition
# ---------------------------------------------------------------------------
SCENARIO_CELL = "dir01-crash-cohort"
# The reference's DSS/TSS model (``SimulationConfig``, its ``config.json``):
# 50 topics, H=(100, 100), B=64 over a 5,000-word generator; the matrix's
# own cells are CPU-sized (V=100, K=4, H=(16,)).
SCENARIO_WIDTHS = dict(n_topics=50, n_components=50, hidden_sizes=(100, 100), batch_size=64,
                       vocab_size=5_000, total_docs=3_072)


def cell_local_steps(workdir: str) -> int:
    """The local steps a cell's clients took, from their streams alone: each
    client's stepper times every step but its first (``stepper_step_s``),
    and a client that answered a poll took at least one."""
    from gfedntm_tpu_torch.utils.observability import read_metrics

    steps = 0
    for path in sorted(Path(workdir).glob("client*/metrics.jsonl")):
        last = {}
        for r in read_metrics(str(path)):
            if r.get("event") == "metrics_snapshot":
                last = r["metrics"]
        polls = (last.get("client_polls") or {}).get("value", 0)
        timed = (last.get("stepper_step_s") or {}).get("count", 0)
        steps += timed + 1 if polls else 0
    return int(steps)


def scenario_phase(card: str, notes: dict) -> None:
    """Phase 16: ``dir01-crash-cohort`` at the reference's widths and its
    no-fault twin through the port's ``run_matrix`` on the card."""
    import dataclasses

    import numpy as np
    import torch

    from gfedntm_tpu_torch.data.vocab import Vocabulary, vectorize
    from gfedntm_tpu_torch.federation.server import build_template_model
    from gfedntm_tpu_torch.ops import fused_decoder as fd
    from gfedntm_tpu_torch.scenarios import (
        build_corpora,
        cell_bench_row,
        default_matrix,
        emit_artifact,
        run_matrix,
    )
    from gfedntm_tpu_torch.scenarios import runner
    from gfedntm_tpu_torch.utils.observability import MetricsLogger, read_metrics

    t_phase = time.perf_counter()
    headline = {c.name: c for c in default_matrix()}[SCENARIO_CELL]
    cell = dataclasses.replace(headline, **SCENARIO_WIDTHS)
    workdir = SCRATCH / "scenarios"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    harness = MetricsLogger(str(workdir / "metrics.jsonl"), node="scenarios", validate=True)
    fd.reset_launches()
    try:
        results = run_matrix([cell], str(workdir), metrics=harness, device="cuda:0")
    finally:
        harness.close()
    torch.cuda.synchronize()
    launches = dict(fd.LAUNCHES)
    names = [r.cell.name for r in results]
    check(names == [f"{SCENARIO_CELL}-baseline", SCENARIO_CELL],
          f"phase 16: run_matrix ran {names}")
    crash = results[1]
    for res in results:
        red = {k: v["detail"] for k, v in res.contracts.items() if not v["ok"]}
        print(f"scenarios, {card}: {res.cell.name}: ok {res.ok}, {res.evidence['rounds']} "
              f"rounds in {res.seconds:.2f} s; contracts "
              f"{ {k: v['ok'] for k, v in res.contracts.items()} }"
              + (f"; red {red}; error {res.evidence.get('error')}" if red else ""), flush=True)
        check(res.ok, f"phase 16: {res.cell.name}: red contracts {red}")
        check(res.evidence["counters"]["codec_ref_miss"] == 0,
              f"phase 16: {res.cell.name}: codec_ref_miss {res.evidence['counters']}")
    rec = crash.evidence["recovery"] or {}
    check(rec.get("recovered") and rec.get("source") == "journal"
          and rec["resumed_round"] >= rec["killed_round"] - 1,
          f"phase 16: recovery {rec}")
    steps = {r.cell.name: cell_local_steps(r.workdir) for r in results}
    for name in ("stats", "loss", "grads"):
        check(launches[name] == sum(steps.values()),
              f"phase 16: {name} launched {launches[name]} times, the clients took "
              f"{steps} local steps")
        notes[name] += f"; phase 16 scenario matrix ({SCENARIO_CELL} and its twin): " \
                       f"{launches[name]} launches"
    try:  # each row and the artifact are validated where they are emitted
        for res in results:
            cell_bench_row(res)
        artifact = emit_artifact(results, rev="r00")
    except ValueError as err:
        raise SmokeFailure(f"phase 16: {err}") from err
    check(artifact["acceptance"]["headline_green"]
          and artifact["acceptance"]["headline_cell"] == SCENARIO_CELL,
          f"phase 16: acceptance {artifact['acceptance']}")
    # K1-K3 against their plain versions on a batch of client 1's corpus at
    # the cell's V: the consensus vocabulary from the server's journal, the
    # template the server builds from the cell's seed.
    journal = json.loads((Path(crash.workdir) / "server" / "checkpoints"
                          / "journal.json").read_text())
    vocab = Vocabulary(tuple(journal["vocab"]))
    kw = runner._model_kwargs(cell)
    net = build_template_model("avitm", len(vocab), kw)
    corpora, _ref = build_corpora(cell)
    X = vectorize(corpora[0].documents, vocab)
    B = cell.batch_size
    kernels_against_plain("client 1's first documents", "scenarios", net, X[:B],
                          np.ones(B, dtype=np.float32))
    V = len(vocab)

    def rounds(server_dir: Path) -> list:
        return [r for r in read_metrics(str(server_dir / "metrics.jsonl"))
                if r.get("event") == "span" and r.get("name") == "round"]

    killed, recovered = (rounds(Path(crash.workdir) / d) for d in ("server", "server_recovered"))
    print(f"scenarios, {card}: V={V} (the {16 if V % 4 == 0 else 4}-byte cp.async ring); "
          f"local steps {steps}; launches {nonzero(launches)}; recovery {rec}, "
          f"{recovered[0]['time'] - killed[-1]['time']:.3f} s from the killed server's last "
          f"round to the replacement's first", flush=True)
    for res in results:
        spans = [r for d in sorted(Path(res.workdir).glob("server*")) for r in rounds(d)]
        ms = float(np.median([r["seconds"] for r in spans])) * 1e3
        per_round = float(np.median([r.get("bytes_pulled", 0) + r.get("bytes_pushed", 0)
                                     for r in spans])) / 1e6
        print(f"scenarios {res.cell.name}, {card}: {res.evidence['rounds']} rounds, "
              f"{res.seconds:.2f} s; median {ms:.3f} ms per round ({len(spans)} round spans), "
              f"{per_round:.3f} MB per round pulled and pushed; NPMI final "
              f"{res.evidence['npmi_final']:.4f} (baseline {res.evidence['baseline_npmi']:.4f}, "
              f"tolerance {res.cell.npmi_tol:g})", flush=True)
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)



# ---------------------------------------------------------------------------
# Phase 17: one client over several devices, and the trainer over client ranks
# ---------------------------------------------------------------------------
MESH_RANKS = 2  # 17(a)'s and 17(b)'s ranks (gloo on cuda:0 on a one-card host)
MESH_STEPS = 8  # 17(a)'s mesh stepper: local steps of one client
MESH_BETA_TOL = 1e-4  # 17(a): beta, 2 ranks vs 1 (tests/test_multichip.py:277-302), or a witness's spread
#: 17(a)'s fallback bound of the trainer over ranks against phase 3's fit,
#: used only when the two are not bitwise equal (the reason is printed).
MESH_FALLBACK_TOL = 1e-6
MESH_KW = dict(input_size=100_000, n_components=50, hidden_sizes=(100, 100), batch_size=256,
               num_epochs=2)


def mesh_calls(datasets: list) -> dict:
    """Phase 17(a)'s rank programs for :func:`rank_groups` (2 ranks): the
    mesh stepper on client 1's corpus of phase 3, and the trainer over 2
    client ranks on both of phase 3's corpora at phase 3's settings."""
    from gfedntm_tpu_torch.parallel import programs

    corpora = [shared(d.X) for d in datasets]
    return {
        "mesh stepper": (MESH_RANKS, programs.mesh_steps,
                         ({**MESH_KW, "fused_decoder": False}, corpora[0], MESH_STEPS)),
        "mesh trainer": (MESH_RANKS, programs.federated_fit, (MESH_KW, corpora)),
    }


def start_mesh_programs(datasets: list):
    """17(a)'s rank group (:func:`mesh_calls`) on a thread of this process,
    which only waits for its ranks; returns the future of its results."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(rank_groups, mesh_calls(datasets))
    pool.shutdown(wait=False)
    return future


def mesh_stepper_check(card: str, res: list, X) -> None:
    """17(a)'s mesh stepper against the one-rank stepper on the card (the
    same state, schedule and noise, the unfused decode): beta within 1e-4
    after every step (the JAX pin), or, where Adam turns the reduction
    order's rounding of near-zero gradients into larger steps (as phases 4
    and 6(b) saw), within the spread a second order of the same sums gives:
    the one-rank stepper through the fused kernels against the unfused one,
    no larger than 1.5x its max (or 4 lr) and with no more than 1.5x its
    entries past 1e-4. Also: the batch axis padded to a multiple of the
    ranks, one state on both ranks, no kernel launched."""
    import numpy as np

    from gfedntm_tpu_torch import AVITM, BowDataset
    from gfedntm_tpu_torch.federated.stepper import FederatedStepper

    def stepper(fused):
        s = FederatedStepper(AVITM(**MESH_KW, fused_decoder=fused))
        s.pre_fit(BowDataset(X=X))
        return s

    one, witness = stepper(False), stepper("auto")
    lr = one.model.lr
    worst, worst_w, lines = 0.0, 0.0, []
    for step, beta in enumerate(res[0]["betas"], 1):
        for s in (one, witness):
            s.delta_update_fit(s.train_mb_delta())
        ref = one.model.model.beta.detach().cpu().numpy()
        d = np.abs(beta - ref)
        w = np.abs(witness.model.model.beta.detach().cpu().numpy() - ref)
        worst, worst_w = max(worst, float(d.max())), max(worst_w, float(w.max()))
        past, past_w = int((d > MESH_BETA_TOL).sum()), int((w > MESH_BETA_TOL).sum())
        lines.append(f"{step}: {float(d.max()):.3e} ({past} past 1e-4) / witness "
                     f"{float(w.max()):.3e} ({past_w})")
        check(float(d.max()) <= MESH_BETA_TOL
              or (float(d.max()) <= max(4 * lr, 1.5 * float(w.max()))
                  and past <= 1.5 * past_w),
              f"phase 17(a): mesh stepper beta after step {step}: max |diff| "
              f"{float(d.max()):.3e} with {past} entries past {MESH_BETA_TOL:g}, the fused "
              f"witness {float(w.max()):.3e} with {past_w}")
    shape = res[0]["schedule_shape"]
    print(f"mesh (a) stepper, {card}: {MESH_RANKS} ranks, {len(res[0]['betas'])} local steps "
          f"of one client (1,024 documents, V={MESH_KW['input_size']}, fused_decoder=False); "
          f"schedule {shape}; beta against the one-rank stepper (max |diff|, entries past "
          f"{MESH_BETA_TOL:g}) and the fused witness against it, per step: {'; '.join(lines)}; "
          f"within {MESH_BETA_TOL:g} at every step: {worst <= MESH_BETA_TOL}; statuses "
          f"{res[0]['statuses'][-1]}; launches {[nonzero(r['launches']) for r in res]}",
          flush=True)
    check(len(res[0]["betas"]) == MESH_STEPS, f"phase 17(a): {len(res[0]['betas'])} steps")
    check(shape[1] % MESH_RANKS == 0, f"phase 17(a): schedule {shape} not padded to a "
          f"multiple of {MESH_RANKS}")
    check(all(r["digest"] == res[0]["digest"] for r in res[1:]),
          "phase 17(a): the mesh stepper's ranks hold different states")
    check(all(not nonzero(r["launches"]) for r in res),
          f"phase 17(a): the mesh stepper launched {[r['launches'] for r in res]}")


def mesh_trainer_check(card: str, notes: dict, res: list, result) -> None:
    """17(a)'s trainer over 2 client ranks against phase 3's one-device fit
    (``result``): bitwise (else within :data:`MESH_FALLBACK_TOL`, the reason
    printed), 8 launches of K1-K3 on each rank, the shared state bitwise
    equal across ranks, ``federated_mesh_devices`` 2."""
    import numpy as np

    want = [{**{k: v.cpu().numpy() for k, v in p.items()},
             **{k: v.cpu().numpy() for k, v in b.items()}}
            for p, b in zip(result.client_params, result.client_batch_stats)]
    got = res[0]["states"]
    diffs = {}
    for c, (g, w) in enumerate(zip(got, want)):
        for key in w:
            if not np.array_equal(g[key], w[key]):
                diffs[f"client {c + 1} {key}"] = float(
                    np.abs(g[key].astype(np.float64) - w[key]).max())
    bitwise = not diffs and len(got) == len(want)
    losses_equal = bool(np.array_equal(res[0]["losses"], result.losses))
    print(f"mesh (a) trainer, {card}: {res[0]['ranks']} client ranks, one client each, phase "
          f"3's configuration (8 global steps); launches per rank "
          f"{[nonzero(r['launches']) for r in res]}; federated_mesh_devices "
          f"{[r['mesh_devices'] for r in res]}; state against phase 3's one-device fit: "
          + ("bitwise" if bitwise else f"not bitwise, worst {max(diffs.values()):.3e} in "
             f"{max(diffs, key=diffs.get)} ({len(diffs)} entries differ)")
          + f"; step losses bitwise {losses_equal}", flush=True)
    if not bitwise:
        worst = max(diffs.values(), default=float("inf"))
        print("mesh (a) trainer: the fallback bound applies: a rank's FedAvg reduces the "
              "gathered stack with the one-device arithmetic, so the difference comes from "
              f"the entries above ({sorted(diffs)[:6]})", flush=True)
        check(worst <= MESH_FALLBACK_TOL, f"phase 17(a): the trainer over ranks differs from "
              f"phase 3's fit by {worst:.3e} (limit {MESH_FALLBACK_TOL:g})")
    for rank, r in enumerate(res):
        for name in ("stats", "loss", "grads"):
            check(r["launches"][name] == MESH_STEPS, f"phase 17(a): rank {rank}: {name} "
                  f"launched {r['launches'][name]} times, want {MESH_STEPS}")
        check(r["mesh_devices"] == float(MESH_RANKS),
              f"phase 17(a): rank {rank}: federated_mesh_devices {r['mesh_devices']}")
        check(r["digests"] == res[0]["digests"],
              f"phase 17(a): rank {rank}'s clients differ from rank 0's")
    shared_keys = [k for k in want[0] if not k.endswith("num_batches_tracked")]
    for key in shared_keys:
        check(np.array_equal(got[0][key], got[1][key]),
              f"phase 17(a): {key} differs between the clients after the last FedAvg")
    for name in ("stats", "loss", "grads"):
        notes[name] += (f"; phase 17(a) trainer over {MESH_RANKS} client ranks: "
                        f"{res[0]['launches'][name]} launches per rank")


class MeshFederation:
    """17(b): a server, client 1 with ``--mesh_devices 2`` and client 2
    plain, each a process of its own on the card, on phase 15's archive and
    INI; both clients profiled over rounds [2, 3). :meth:`start` starts the
    server, and the clients from a thread once the server listens;
    :meth:`finish` waits for every process and checks the run."""

    def __init__(self, archive: Path, ini: Path):
        self.archive, self.ini = archive, ini
        self.fed = CLI_DIR / "mesh_fed"
        self.procs: list = []
        self.started = time.perf_counter()

    def start(self) -> "MeshFederation":
        import threading

        port, *client_ports = free_ports(3)
        common = ["--config", str(self.ini), "--save_dir", str(self.fed)]
        server = CliProcess("mesh server", ["--id", "0", "--min_clients_federation", "2",
                                            "--max_iters", str(CLI_STEPS), "--listen_port",
                                            str(port)] + common, CLI_LIMIT_S["mesh server"])
        self.procs = [server]
        self.up, self.error = None, None

        def clients():
            try:
                self.up = wait_for_port(port, server, "server listening")
                for c in (1, 2):
                    extra = (["--mesh_devices", str(MESH_RANKS)] if c == 1 else []) + [
                        "--profile_dir", str(self.fed / f"prof{c}"), "--profile_rounds", "2:3"]
                    self.procs.append(CliProcess(f"mesh client{c}", [
                        "--id", str(c), "--source", str(self.archive), "--server_address",
                        f"localhost:{port}", "--listen_port", str(client_ports[c - 1])]
                        + common + extra, CLI_LIMIT_S["mesh client"]))
            except SmokeFailure as err:
                self.error = err

        self.launcher = threading.Thread(target=clients, daemon=True)
        self.launcher.start()
        return self

    def stop(self) -> None:
        self.launcher.join(CLI_LIMIT_S["mesh server"])
        for p in self.procs:
            p.stop()

    def finish(self, card: str) -> float:
        """Wait for the processes and check the run; returns the seconds
        since :meth:`start`."""
        import numpy as np

        try:
            self.launcher.join(CLI_LIMIT_S["mesh server"])
            if self.error is not None:
                raise self.error
            check(len(self.procs) == 3, f"phase 17(b): {len(self.procs)} processes started")
            walls = [p.finish() for p in self.procs]
        finally:
            self.stop()
        seconds = time.perf_counter() - self.started
        fed = self.fed
        check((fed / "server_model.npz").is_file(), "phase 17(b): no server_model.npz")
        with np.load(fed / "client1" / "model.npz") as a, \
                np.load(fed / "client2" / "model.npz") as b:
            same = a["betas"].shape == b["betas"].shape and bool(np.array_equal(a["betas"],
                                                                                b["betas"]))
            V = a["betas"].shape[1]
        check(same, "phase 17(b): the clients' betas differ after the last aggregate")
        mesh_log = jsonl(fed / "client1" / "metrics.jsonl")
        ranks = [r for r in mesh_log
                 if r.get("event") == "phase" and r.get("phase") == "mesh_ranks"]
        check(len(ranks) == 1 and ranks[0]["ranks"] == MESH_RANKS and ranks[0]["equal"] is True,
              f"phase 17(b): the mesh client's rank check {ranks}")
        kernels = {}
        for c in (1, 2):
            traces = sorted((fed / f"prof{c}").glob("*.pt.trace.json"))
            check(len(traces) == 1, f"phase 17(b): client {c}'s traces {traces}")
            kernels[c] = trace_kernels(traces[0])
        server_log = jsonl(fed / "metrics.jsonl")
        rounds = sorted((r for r in server_log if r.get("event") == "span"
                         and r.get("name") == "round"), key=lambda r: r["round"])
        ms = float(np.median([r["seconds"] for r in (rounds[1:] or rounds)])) * 1e3
        snaps = [r for r in mesh_log if r.get("event") == "metrics_snapshot"]
        gauges = snaps[-1]["metrics"] if snaps else {}
        spans = {}
        for c in (1, 2):
            for r in jsonl(fed / f"client{c}" / "metrics.jsonl"):
                if r.get("event") == "span" and r.get("name") in (
                        "offer_vocab", "get_setup", "revectorize", "pre_fit", "finalize"):
                    spans[f"{c}:{r['name']}"] = round(r["seconds"], 2)
        phase15 = STEADY_MS.get("phase 15")
        print(f"mesh (b) wire federation, {card}: a server, client 1 over {MESH_RANKS} ranks "
              f"(--mesh_devices {MESH_RANKS}) and client 2 on one device, each a process of "
              f"its own, each exit 0 (wall {', '.join(f'{w:.1f}' for w in walls)} s; the "
              f"server listened after {self.up:.1f} s); global V={V}, {len(rounds)} rounds, "
              f"the first begun {rounds[0]['time'] - rounds[0]['seconds'] - server_log[0]['time']:.1f} s "
              f"after the server's first record; median ms per global step over rounds "
              f"2-{len(rounds)} {ms:.3f} (phase 15(b), two one-device clients: "
              + (f"{phase15:.3f} ms this run)" if phase15 else "not run in this call)")
              + f"; client spans (s) {spans}; the mesh client's ranks bitwise equal "
              f"({ranks[0]['seconds'] * 1e3:.1f} ms to read their digests); its "
              f"sharded_compile_s {gauges.get('sharded_compile_s', {}).get('value')}, "
              f"sharded_docs_per_s {gauges.get('sharded_docs_per_s', {}).get('value')}; the "
              f"clients' betas bitwise equal; kernels in client 1's trace {kernels[1]}, in "
              f"client 2's {kernels[2]}", flush=True)
        check(len(rounds) == CLI_STEPS, f"phase 17(b): {len(rounds)} rounds, want {CLI_STEPS}")
        check(all(kernels[2].get(f, 0) > 0 for f in TENSOR_CORE_FAMILIES),
              f"phase 17(b): client 2's trace names kernels {kernels[2]}")
        check(not any(kernels[1].get(f, 0) for f in TENSOR_CORE_FAMILIES),
              f"phase 17(b): the mesh client's trace names K1-K3 {kernels[1]}")
        return seconds


def cli_archive() -> tuple:
    """Phase 15's corpus as a reference archive and its INI under
    :data:`CLI_DIR` (made when absent: a run with phase 15 has them)."""
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus, save_reference_npz

    archive, ini = CLI_DIR / "corpus.npz", CLI_DIR / "cli.cf"
    if not archive.is_file():
        CLI_DIR.mkdir(parents=True, exist_ok=True)
        corpus = generate_synthetic_corpus(vocab_size=100_000, n_topics=50, n_docs=1024,
                                           n_nodes=2, materialize_docs=True, seed=0)
        save_reference_npz(corpus, str(archive))
        ini.write_text(CLI_INI)
    return archive, ini


def mesh_phase(card: str, notes: dict, groups: dict | None = None, result=None,
               datasets=None, federation: MeshFederation | None = None,
               meanwhile=None) -> None:
    """Phase 17: (a) the mesh stepper and the trainer over 2 client ranks in
    a rank group of their own (``groups``, the future of
    :func:`start_mesh_programs` started before phase 13 in a run of every
    phase; run here, with phase 3's fit, under ``--mesh-only``); (b) the
    command line with a mesh
    client (``federation``, started in phase 15 in a run of every phase,
    else here), whose processes run while (a)'s checks and ``meanwhile()``
    (the wait for phase 18's process) run in this process; an error in
    either fails the phase once the processes have ended."""
    from gfedntm_tpu_torch import AVITM, FederatedTrainer

    t_phase = time.perf_counter()
    if federation is None:
        federation = MeshFederation(*cli_archive()).start()
    try:
        if datasets is None:
            datasets = main_path_datasets()
        t0 = time.perf_counter()
        if groups is None:
            groups = rank_groups(mesh_calls(datasets))
        else:
            groups = groups.result()  # started before phase 13
        print(f"mesh (a): its rank group's results after {time.perf_counter() - t0:.1f} s "
              f"here", flush=True)
        if result is None:
            result = FederatedTrainer(AVITM(**MESH_KW), n_clients=2).fit(datasets)
        backend, devices = groups[f"layout/{MESH_RANKS}"]
        print(f"mesh (a): {backend} on {devices}", flush=True)
        mesh_stepper_check(card, groups["mesh stepper"], datasets[0].X)
        mesh_trainer_check(card, notes, groups["mesh trainer"], result)
        if meanwhile is not None:
            meanwhile()
    except BaseException:
        federation.stop()
        raise
    b_s = federation.finish(card)
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s here, (b) {b_s:.1f} s since "
          f"its processes started ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 18: the experiment harnesses
# ---------------------------------------------------------------------------
#: The reference's DSS/TSS regime (``SimulationConfig``'s widths: V=5,000,
#: K=50, H=(100, 100), B=64, lr 2e-3, 5 nodes, eta 0.01, the eta sweep's
#: frozen_topics_list[1] = 10), cut as :data:`EXPERIMENT_CUTS` says.
EXPERIMENT_CONFIG = dict(vocab_size=5000, n_topics=50, beta=0.01, n_nodes=5, experiment=1,
                         eta_list=(0.01,), hidden_sizes=(100, 100), batch_size=64, lr=2e-3,
                         seed=0)
#: The cuts of phase 18 (published: 10,000 training and 1,000 held-out
#: documents a node, 100 epochs, 20 iterations).
EXPERIMENT_CUTS = dict(n_docs=2000, n_docs_global_inf=200, num_epochs=10, iters=1)
#: The published envelope (``results/dss_tss_eta001/results.json``, eta 0.01).
PUBLISHED = Path(__file__).resolve().parent / "results" / "dss_tss_eta001" / "results.json"
#: Phase 18's artifacts and models; ``main`` removes it.
EXPERIMENTS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_experiments"
#: Phase 18's own limit, in seconds, when it runs in a process of its own.
EXPERIMENTS_LIMIT_S = 600.0


def experiments_phase_joined(card: str, notes: dict, experiments: ExperimentsProcess) -> None:
    """Wait for phase 18's process (:class:`ExperimentsProcess`) and take in
    its notes."""
    seconds = experiments.finish(notes)
    print(f"phase 18's process ended {seconds:.1f} s after its start (beside phases 13-17) "
          f"({card})", flush=True)


def _experiments_child(card: str, results) -> None:
    """Phase 18 in a process of its own: puts ``("ok", its kernels' notes)``,
    ``("failed", message)`` or ``("error", traceback)`` on ``results``."""
    import traceback

    notes = {"stats": "", "loss": "", "grads": ""}
    try:
        experiments_phase(card, notes)
        results.put(("ok", notes))
    except SmokeFailure as err:
        results.put(("failed", str(err)))
    except BaseException:  # reported to the parent, which fails the phase
        results.put(("error", traceback.format_exc()))


class ExperimentsProcess:
    """Phase 18 in a process of its own (``spawn``), so that it runs beside
    the phases this process runs meanwhile; its launches are counted there.
    :meth:`finish` waits for it, merges its notes into ``notes`` and fails
    the run on its failure."""

    def __init__(self, card: str):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=_experiments_child, args=(card, self.results),
                                daemon=True)
        self.started = time.perf_counter()
        self.proc.start()

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(10.0)

    def finish(self, notes: dict) -> float:
        """Seconds from the start to the result; raises on a failure."""
        import queue

        left = EXPERIMENTS_LIMIT_S - (time.perf_counter() - self.started)
        try:
            kind, payload = self.results.get(timeout=max(left, 1.0))
        except queue.Empty:
            kind, payload = "failed", (f"no result within {EXPERIMENTS_LIMIT_S:g} s (exit code "
                                       f"{self.proc.exitcode})")
        finally:
            self.stop()
        check(kind == "ok", f"phase 18 (its own process): {payload}")
        for name, text in payload.items():
            notes[name] += text
        return time.perf_counter() - self.started


def experiments_phase(card: str, notes: dict) -> None:
    """Phase 18: one DSS/TSS iteration at the reference's widths, cut
    (:data:`EXPERIMENT_CUTS`): every arm's scores finite, TSS centralized >
    non-collaborative > random and DSS centralized < non-collaborative, K1-K3
    once per training step of every fit and within tolerance of their plain
    versions on the centralized fit's first batch, ``results.json`` with the
    JAX artifact's columns and ``meta`` keys; then ``TMWrapper``'s AVITM on
    the centralized corpus, its NPMI, RBO and diversity finite."""
    import numpy as np
    import torch

    from gfedntm_tpu_torch.experiments import SimulationConfig, TMWrapper, run_simulation
    from gfedntm_tpu_torch.experiments import dss_tss
    from gfedntm_tpu_torch.models.avitm import AVITM
    from gfedntm_tpu_torch.ops import fused_decoder as fd

    t_phase = time.perf_counter()
    workdir = EXPERIMENTS_DIR
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = SimulationConfig(**EXPERIMENT_CONFIG, **EXPERIMENT_CUTS)
    fits = []  # (arm, V, training steps, seconds, model, documents) per fit
    train = dss_tss._train_avitm

    def timed_train(corpus, c, seed, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(corpus, c, seed, device)
        torch.cuda.synchronize()
        arm = "centralized" if not fits else f"node {len(fits) - 1}"
        fits.append((arm, out[0].input_size, len(out[0].step_losses),
                     time.perf_counter() - t0, out[0], corpus))
        return out

    dss_tss._train_avitm = timed_train
    fd.reset_launches()
    try:
        t0 = time.perf_counter()
        out = run_simulation(cfg, results_dir=workdir, device="cuda:0")
        sim_s = time.perf_counter() - t0
    finally:
        dss_tss._train_avitm = train
    torch.cuda.synchronize()
    launches = dict(fd.LAUNCHES)
    cols = {k: v[0] for k, v in out["columns"].items()}
    steps = sum(f[2] for f in fits)
    for arm, V, n, secs, _, _ in fits:
        print(f"experiments, {card}: {arm} fit at V={V} (the {16 if V % 4 == 0 else 4}-byte "
              f"cp.async ring): {n} training steps in {secs:.2f} s", flush=True)
    published = json.loads(PUBLISHED.read_text())
    pcols = {k: v[0] for k, v in published["columns"].items()}
    print(f"experiments, {card}: one iteration in {sim_s:.1f} s, {len(fits)} fits, {steps} "
          f"training steps; launches {nonzero(launches)}", flush=True)
    for arm in ("centralized", "non_colab", "baseline"):
        print(f"experiments {arm}: TSS {cols[f'{arm}_betas_mean']:.4f} (published "
              f"{pcols[f'{arm}_betas_mean']:.4f}), refmap {cols[f'{arm}_betas_refmap_mean']:.4f}"
              f" (published {pcols[f'{arm}_betas_refmap_mean']:.4f}), DSS "
              f"{cols[f'{arm}_thetas_mean']:.2f} (published {pcols[f'{arm}_thetas_mean']:.2f}; "
              f"the cut infers {EXPERIMENT_CUTS['n_docs_global_inf']} held-out documents a node, "
              f"not 1,000)", flush=True)
    check(len(fits) == 1 + cfg.n_nodes, f"phase 18: {len(fits)} fits")
    check(all(math.isfinite(v) for v in cols.values()), f"phase 18: non-finite scores {cols}")
    check(cols["centralized_betas_mean"] > cols["non_colab_betas_mean"]
          > cols["baseline_betas_mean"], f"phase 18: TSS ordering {cols}")
    check(cols["centralized_thetas_mean"] < cols["non_colab_thetas_mean"],
          f"phase 18: DSS ordering {cols}")
    for name in ("stats", "loss", "grads"):
        check(launches[name] == steps, f"phase 18: {name} launched {launches[name]} times, "
              f"the fits took {steps} training steps")
        notes[name] += f"; phase 18 experiments: {launches[name]} launches ({len(fits)} fits)"
    check(out.keys() == published.keys() and out["columns"].keys() == published["columns"].keys()
          and out["meta"].keys() == published["meta"].keys()
          and out["meta"]["regime"].keys() == published["meta"]["regime"].keys(),
          f"phase 18: the artifact's keys {sorted(out)} / {sorted(out['meta'])}")
    saved = json.loads((workdir / "results.json").read_text())
    check(saved["meta"]["backend"] == "cuda" and saved["columns"].keys() == out["columns"].keys(),
          f"phase 18: results.json meta {saved['meta'].get('backend')}")
    central: AVITM = fits[0][4]
    data = central.train_data
    B = central.batch_size
    kernels_against_plain("the centralized fit's first batch", "experiments", central,
                          data.X[:B], np.ones(B, dtype=np.float32))

    # TMWrapper's AVITM on the centralized corpus (the union of the nodes'
    # training documents).
    docs = fits[0][5]
    wrapper = TMWrapper(workdir / "models", device="cuda:0")
    t0 = time.perf_counter()
    model, model_dir = wrapper.train_model(
        "centralized", docs, model_type="avitm", n_topics=cfg.n_topics,
        model_kwargs=dict(hidden_sizes=cfg.hidden_sizes, batch_size=cfg.batch_size, lr=cfg.lr,
                          num_epochs=cfg.num_epochs))
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = wrapper.evaluate_model(model, reference_corpus=docs)
    eval_s = time.perf_counter() - t0
    print(f"experiments TMWrapper, {card}: AVITM at V={model.input_size}, "
          f"{len(model.step_losses)} training steps in {train_s:.2f} s ({model_dir.name}: "
          f"{sorted(p.name for p in model_dir.iterdir())}); evaluate {eval_s:.2f} s: "
          f"{ {k: round(v, 4) for k, v in metrics.items()} }", flush=True)
    check(set(metrics) == {"topic_diversity", "inverted_rbo", "npmi"}
          and all(math.isfinite(v) for v in metrics.values()),
          f"phase 18: TMWrapper metrics {metrics}")
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


# ---------------------------------------------------------------------------
# Phase 19: the port's static-analysis gate
# ---------------------------------------------------------------------------
#: Phase 19's own limit, in seconds.
LINT_LIMIT_S = 300.0
#: graftlint's summary line (``python -m gfedntm_tpu_torch.analysis``).
LINT_SUMMARY = re.compile(r"graftlint: (\d+) files, (\d+) rules -> (\d+) new finding\(s\), "
                          r"(\d+) baselined, (\d+) stale")
#: A new finding on graftlint's standard error.
LINT_FINDING = re.compile(r"^\S+:\d+: \[([\w-]+) (GL\d+)\]", re.M)


class LintProcess:
    """Phase 19 in a process of its own: ``python -m gfedntm_tpu_torch.analysis``
    from this script's directory, started with the script. A thread waits
    for it and takes its end time; :meth:`finish` joins the thread, prints
    the phase's line and fails the run on a nonzero exit."""

    def __init__(self):
        import threading

        root = Path(__file__).resolve().parent
        self.started = time.perf_counter()
        self.ended = None
        self.out = self.err = ""
        self.proc = subprocess.Popen([sys.executable, "-m", "gfedntm_tpu_torch.analysis"],
                                     cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self) -> None:
        self.out, self.err = self.proc.communicate()
        self.ended = time.perf_counter()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.waiter.join(10.0)

    def finish(self, card: str) -> None:
        t0 = time.perf_counter()
        self.waiter.join(max(LINT_LIMIT_S - (t0 - self.started), 1.0))
        join_s = time.perf_counter() - t0
        if self.ended is None:
            self.stop()
            check(False, f"phase 19: graftlint gave no result within {LINT_LIMIT_S:g} s")
        rc = self.proc.returncode
        check(rc == 0, f"phase 19: graftlint exit code {rc}: {self.out[-2000:]}"
                       f"{self.err[-4000:]}")
        m = LINT_SUMMARY.search(self.out)
        check(m is not None, f"phase 19: no graftlint summary in {self.out[-2000:]!r}")
        files, n_rules, new, baselined, stale = map(int, m.groups())
        breakdown = lint_breakdown(self.err)
        print(f"phase 19: graftlint over the port: {files} files, {n_rules} rules, {breakdown} "
              f"(new/baselined/suppressed); {new} new, {baselined} baselined, {stale} stale; "
              f"the lint took {self.ended - self.started:.1f} s beside phases 1-18; serial "
              f"cost {time.perf_counter() - t0:.2f} s (the join {join_s:.2f} s) ({card})",
              flush=True)


def lint_breakdown(err: str) -> str:
    """Per rule, ``new/baselined/suppressed``: the new findings on
    graftlint's standard error, the port baseline's entries (all matched:
    the gate fails on unjustified ones and the summary counts stale ones),
    and the inline suppression comments (``graftlint: disable=``) in the
    scanned files."""
    import tokenize

    from gfedntm_tpu_torch.analysis.core import _SUPPRESS_RE, collect_default_files
    from gfedntm_tpu_torch.analysis.rules import make_default_rules
    from gfedntm_tpu_torch.analysis.runner import default_baseline_path

    root = str(Path(__file__).resolve().parent)
    rules = make_default_rules()
    new = {r.name: 0 for r in rules}
    for name, _rid in LINT_FINDING.findall(err):
        new[name] = new.get(name, 0) + 1
    based = dict.fromkeys(new, 0)
    for entry in json.loads(Path(default_baseline_path(root)).read_text())["entries"]:
        based[entry["rule"]] = based.get(entry["rule"], 0) + 1
    suppressed = dict.fromkeys(new, 0)
    for path in collect_default_files(root):
        with open(path, "rb") as fh:
            comments = [t.string for t in tokenize.tokenize(fh.readline)
                        if t.type == tokenize.COMMENT]
        for m in filter(None, map(_SUPPRESS_RE.search, comments)):
            for name in m.group(1).split(","):
                suppressed[name.strip()] = suppressed.get(name.strip(), 0) + 1
    return ", ".join(f"{r.id} {r.name} {new[r.name]}/{based[r.name]}/{suppressed[r.name]}"
                     for r in rules)


def main(argv: list[str]) -> int:
    kernels_only = "--kernels-only" in argv
    dp_only = "--data-parallel-only" in argv
    p7_only = "--phase-7-only" in argv
    ctm_only = "--ctm-only" in argv
    fed_only = "--federation-only" in argv
    planes_only = "--server-planes-only" in argv
    privacy_only = "--privacy-ops-only" in argv
    pacing_only = "--pacing-only" in argv
    hier_only = "--hierarchy-only" in argv
    serve_only = "--serving-only" in argv
    cli_only = "--cli-only" in argv
    scenarios_only = "--scenarios-only" in argv
    mesh_only = "--mesh-only" in argv
    experiments_only = "--experiments-only" in argv
    lint_only = "--lint-only" in argv
    rest = [a for a in argv if a not in ("--kernels-only", "--data-parallel-only",
                                         "--phase-7-only", "--ctm-only", "--federation-only",
                                         "--server-planes-only", "--privacy-ops-only",
                                         "--pacing-only", "--hierarchy-only", "--serving-only",
                                         "--cli-only", "--scenarios-only", "--mesh-only",
                                         "--experiments-only", "--lint-only")]
    usage_ok = not rest or (rest[0] == "--against" and len(rest) == 2)
    against = Path(rest[1]).resolve() if rest and usage_ok else None
    only = (dp_only or p7_only or ctm_only or fed_only or planes_only or privacy_only
            or pacing_only or hier_only or serve_only or cli_only or scenarios_only
            or mesh_only or experiments_only or lint_only)
    if (not usage_ok
            or kernels_only + dp_only + p7_only + ctm_only + fed_only + planes_only
            + privacy_only + pacing_only + hier_only + serve_only + cli_only
            + scenarios_only + mesh_only + experiments_only + lint_only > 1
            or (only and against)):
        print("usage: chip_smoke.py [--kernels-only [--against DIR] | --data-parallel-only | "
              "--phase-7-only | --ctm-only | --federation-only | --server-planes-only | "
              "--privacy-ops-only | --pacing-only | --hierarchy-only | --serving-only | "
              "--cli-only | --scenarios-only | --mesh-only | --experiments-only | "
              "--lint-only]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from gfedntm_tpu_torch.device import resolve_device
        from gfedntm_tpu_torch.ops import _build
    except ImportError as err:
        print(f"chip_smoke: the port is not next to this script ({err})", file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    experiments = None  # phase 18's process, in a run of every phase
    mesh_programs = None  # 17(a)'s rank group, in a run of every phase
    # Phase 19's process, from the script's start in a run of every phase.
    lint = LintProcess() if lint_only or not (only or kernels_only) else None
    card = card_line()
    print(card, flush=True)
    resolve_device(None)
    try:
        if lint_only:
            lint.finish(card)
            return 0
        t0 = time.perf_counter()
        lib = _build.build()
        print(f"build: {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in build_report(lib, _build.build_log):
            print(f"build: {line}", flush=True)
        print(f"phase 1 took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
        if dp_only:
            data_parallel_phase(card, {"vsharded": ""})
            return 0
        if p7_only:
            decodes_and_text_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if ctm_only:
            ctm_phase(card, {name + dt: "" for name in ("stats", "loss", "grads")
                             for dt in ("", "_bf16")})
            return 0
        if fed_only:
            federation_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if planes_only:
            server_planes_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if privacy_only:
            privacy_ops_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if pacing_only:
            pacing_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if hier_only:
            hierarchy_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if serve_only:
            serving_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if cli_only:
            cli_phase(card)
            return 0
        if scenarios_only:
            scenario_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if mesh_only:
            mesh_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0
        if experiments_only:
            experiments_phase(card, {"stats": "", "loss": "", "grads": ""})
            return 0

        def timed(n, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            print(f"phase {n} took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
            return out

        rows, notes = timed(2, kernel_phase, card, against)
        if not kernels_only:
            datasets, result = timed(3, main_path_phase, rows)
            # Phase 4 runs the rank programs of phases 4 to 8 in one rank
            # group per world size.
            X, kw, groups = timed(4, sharded_fit_phase, card, rows, notes)
            timed(5, persistence_phase, card, rows, notes, datasets, result, X, kw,
                  groups["validation"])
            data_parallel_phase(card, notes, groups)
            raw = decodes_and_text_phase(card, notes, groups)
            ctm_phase(card, notes, raw, datasets, groups)
            del groups
            phase9 = federation_phase(card, notes, raw)
            server_planes_phase(card, notes, raw, phase9)
            privacy_ops_phase(card, notes, raw)
            pacing = pacing_phase(card, notes, raw)
            # Phase 18 runs in a process of its own, and 17(a)'s rank
            # programs in a rank group of their own, beside phases 13-17.
            experiments = ExperimentsProcess(card)
            mesh_programs = start_mesh_programs(datasets)
            hierarchy_phase(card, notes, pacing)
            serving_phase(card, notes, raw, phase9)
            # 17(b)'s processes start in phase 15 and run beside phases 15
            # and 16.
            federation = cli_phase(card, result, start_mesh=True)
            try:
                scenario_phase(card, notes)
            except BaseException:
                federation.stop()
                raise
            mesh_phase(card, notes, mesh_programs, result, datasets, federation,
                       meanwhile=lambda: experiments_phase_joined(card, notes, experiments))
            lint.finish(card)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    finally:
        if lint is not None:
            lint.stop()
        if experiments is not None:
            experiments.stop()
        if mesh_programs is not None:
            mesh_programs.exception()  # wait for its ranks to end
        shutil.rmtree(CORPORA, ignore_errors=True)
        shutil.rmtree(SCRATCH, ignore_errors=True)
        shutil.rmtree(SHARDED_SAVE, ignore_errors=True)
        shutil.rmtree(CLI_DIR, ignore_errors=True)
        shutil.rmtree(EXPERIMENTS_DIR, ignore_errors=True)
    for name, row in rows.items():
        print(f"kernel {name}: launches {row['launches']} max_abs_err {row['max_abs_err']:.3e} "
              f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"bound_ms {row['bound_ms']:.4f}; {notes[name]}", flush=True)
    if kernels_only:
        return 0
    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s ({card})", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
