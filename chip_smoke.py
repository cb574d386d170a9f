#!/usr/bin/env python3
"""Smoke test of flinkml_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It drives the PyTorch port only (nothing of JAX, nothing of ``flinkml_tpu``)
and fails with a non-zero exit if any phase fails:

1. prints the card's name and power limit; builds every CUDA kernel from
   ``flinkml_tpu_torch/kernels/csrc`` and the measurement probes of
   ``kernels/probes`` (one ``nvcc`` per source, in parallel) into a fresh
   compile-cache store, a temporary directory named by
   ``FLINKML_TPU_COMPILE_CACHE`` for every process the run starts;
2. kernel phase: each kernel against its plain PyTorch version at the main
   paths' shapes — ``spmv`` at 65,536 and 262,144 rows x 39 slots, dim
   1e6, float32 (and at widths 1, 7, 39, 40, 1,000 and 3,000 on bucket
   views off the 16-byte phase, float32 and float64; the same bits on two
   launches);
   ``fused_chain`` at 100,000 x 32 in float64 and float32, on both of its
   routes, and its new ops at their paths' shapes, each op on both routes
   (the multinomial head at 10,000 x 784 and 100,000 x 32, k=10; the
   KMeans head at 262,144 x 128, k=64, 65,536 x 784, k=10 and k=64 (its
   centroids read from device memory, float32 and float64); the one-hot
   + assemble prologue on Adult's schema, d=108, and on its first four
   categorical columns and one continuous one, d=48); ``segment_sum`` at
   the sparse-fit step (262,144 x 39 cells into
   1e6 segments, float32 and float64, unsorted beside the random-reduction
   floor, and sorted) and with a row payload (2^20 cells x 16 into 65,536
   segments), the sorted path's output block poisoned with NaN first, and
   sorted on ids that do not ascend ([5, 2], [0, 0, 7, 1, 1], 1e6
   shuffled cells) equal to ``index_add_``; ``topk`` bit for bit against
   ``top_k_plain``
   (values and indices) at [4096, 60000] k=5, [1024, 8192] k=16 and
   k=1,024, [256, 2048] k=128 (float32), 1-D n=1e6 k=100 and k=20,000
   (float64, two bands) and on adversarial rows (duplicates, +0/-0,
   -inf-only rows, NaN of both signs; k up to the whole row), short and
   split into segments — with CUDA-event times (L2 flushed before each
   launch), the plain version's and the library call's time, and the bound
   from bytes and operations; then the route probe (the same inputs
   through each of the kernel's routes, timed in turns); then bfloat16
   ``spmv`` at the fit shape, ``segment_sum`` unsorted and sorted at the
   fit step's cells (sorted bit for bit with the in-order adds) and
   ``topk`` at the KNN chunk, each against its plain version with its
   times and its bound at 2 bytes a value;
3. sparse serving path: LogisticRegressionModel (dim 1e6, seeded
   coefficient, built with ``stage_from_arrays``) transforms 65,536
   Criteo-profile SparseVector rows 4 times (a first call, then 3 timed);
   margins are checked against float64 numpy;
4. dense serving path: the four scalers are fitted on seeded data
   (100,000 x 32), an LR head with a seeded coefficient closes the chain,
   and ``PipelineModel.transform`` runs 4 times fused (a first call, then 3
   timed), then per-stage, then after a save -> load round trip; outputs
   are checked against each other and against a float64 numpy reference;
4a. census path (UCI Adult's schema, the a9a source): ``Pipeline.fit`` of
   OneHotEncoder -> VectorAssembler -> StandardScaler ->
   LogisticRegression on 48,842 seeded rows (d = 108), the coefficient
   against float64 numpy; the fused transform of 100,000 rows with
   out-of-range codes against the per-stage path and float64 numpy;
4b. MNIST-width multinomial path: ``Pipeline.fit`` of MinMaxScaler ->
   LogisticRegression(multinomial) on 60,000 x 784 rows in 10 classes
   (5 epochs) against a float64 numpy softmax run; the fused transform of 10,000 rows
   in float32 and float64; a sparse multinomial transform of 65,536
   Criteo-profile rows (k = 10);
4c. KMeans serving path: StandardScaler -> KMeansModel fused at 65,536 x
   784, k=10, 262,144 x 128, k=64 and 65,536 x 784, k=64, the assignments
   equal to the plain chain's away from near ties, and the per-stage path
   timed beside the fused one;
4d. precision tiers (path D): the five-stage chain at 65,536 x 64 float32
   under no policy, ``mixed``, ``mixed_inference`` and
   ``int8_inference``; the census pipeline and MNIST-width multinomial
   under ``mixed_inference`` and ``int8_inference``; StandardScaler ->
   KMeans (262,144 x 128, k=64) under ``mixed_inference``, and under
   ``mixed`` refused with FML601 before any launch or program;
   StandardScaler -> KMeans at 65,536 x 784, k=128 under
   ``int8_inference`` (an int8 table larger than shared memory: the float
   table, its head from device memory). Each:
   rows/s fused (reading ``prediction`` back) and per-stage, the
   ``fused_chain`` launch against the plain chain at the same policy (the
   rows near a decision's boundary counted), its time, device time and
   bound from the bytes at each width;
5. dense fit path: ``LogisticRegression().fit`` on the bench's a9a-width
   data (1,000,000 x 123 float32, batch 262,144, 10 epochs, tol 0), twice
   (a first fit, then a steady one), the coefficient held against a float64
   numpy run of the same steps; the device loop timed alone;
6. sparse fit path: ``LogisticRegression().fit`` on 262,144 Criteo-profile
   SparseVector rows (dim 1e6, batch 262,144, 10 epochs, tol 0; layout
   ``unsorted``), twice, and ``train_linear_model_sparse_csr`` with layout
   ``sorted``, each held against a float64 numpy run of the same steps;
   the host's CSR conversion and packing timed apart from the device loop;
6a. streamed out-of-core sparse LR (path E): ``LogisticRegression().fit``
   of a DataCache of 8 Criteo-profile CSR batches of 65,536 rows (dim
   1e6), half of them spilled to disk by the cache's memory budget, 2
   epochs with a checkpoint every epoch; a fit stopped at epoch 1 and
   resumed to 2; the same fit from an in-RAM cache; each against a float64 numpy
   run of the same steps and against each other (1e-5 of the largest
   coefficient); samples/s, device share, the feed's wait per epoch, the
   step's ``spmv`` and ``segment_sum`` time per batch and the latter on
   the same cell count without padding;
6b. BASELINE config #3 (path F): LinearSVC and LinearRegression (SGD) at
   1,000,000 x 123 float32, batch 262,144, reg 2e-4, elasticNet 0.5, 10
   epochs; LinearRegression ``solver="normal"``; a sparse LinearSVC on
   262,144 Criteo rows; a streamed LinearRegression over 16 batches;
   LinearSVCModel serving 65,536 Criteo and 100,000 dense rows; each
   against float64 numpy;
6c. BASELINE config #4 (path G): ``OnlineLogisticRegression.fit_stream``
   over 64 batches of 16,384 x 123 float32 rows with a checkpoint every
   16; a run crashed at batch 32 and resumed equal to the uninterrupted
   one bit for bit; against a float64 numpy FTRL; batches/s and
   samples/s;
6d. the input pipeline (path H): H1, ``Dataset.from_libsvm`` of 262,144
   a9a-shaped rows written to a LibSVM file (native parser), shuffled and
   prefetched into ``LogisticRegression().fit`` (5 epochs) against
   float64 numpy in the same batch order; H2, a prefetched ``Dataset`` of
   4 Criteo-profile batches of 65,536 ``SparseVector`` rows (dim 1e6)
   through the sorted-column stream (``spmv`` and the sorted
   ``segment_sum``), 2 epochs, against float64 numpy and path E's CSR
   stream, the two kernels held against their plain versions on the
   stream's own block and the sorted ``segment_sum`` timed with and
   without the block's padding run; H3, ``OnlineLogisticRegression.
   fit_stream`` over an ``ElasticFeed`` at path G's width stopped at
   world 4 and resumed at world 2, bit for bit with the uninterrupted
   run;
6e. the cumsum layout and the rest of KMeans (path I): I1,
   ``train_linear_model_sparse_csr(layout="cumsum")`` at the sparse fit
   path's shape against float64 numpy and the ``unsorted`` fit, its host
   tables and device loop timed apart, two runs bit for bit, and
   ``BatchedCSR.matvec``/``rmatvec`` at 65,536 Criteo rows against their
   plain versions; I2, ``KMeans().fit`` over 4 batches of 65,536 x 784
   float32 rows (half spilled by the cache's budget), 4 epochs with a
   checkpoint every 2, a run from a sealed cache crashed at epoch 2 and
   resumed bit for bit, against the in-RAM ``train_kmeans`` from the same
   init, then served behind a StandardScaler through ``fused_chain``; I3,
   ``OnlineKMeans.fit_stream`` over 16 batches of 16,384 x 784 drifting
   blobs, crashed at batch 8 and resumed bit for bit, against a float64
   numpy decay rule. Path I must launch ``spmv``, ``segment_sum`` and
   ``fused_chain``;
6f. ``parallel/`` on ``torch.distributed`` (path J): J1,
   ``init_distributed`` at world 1 over nccl through a ``file://`` store,
   then the sparse LR fit at path B's width (``unsorted`` and ``sorted``),
   the dense LR fit at path 5's width and ``KMeans`` at 262,144 x 128,
   k=64 (20 epochs; the LR fits 4), each with ``mesh=DeviceMesh()`` and without: equal
   bit for bit (the ``unsorted`` fit, whose ``segment_sum`` adds by
   atomics, within 1e-5), the fits against float64 numpy; J2, two ranks
   spawned by the script on the one card over gloo with CUDA tensors
   (``--j2-rank``), running the sparse and dense fits on a two-rank mesh
   and ``keyed_aggregate`` of the fit's cells: the ranks equal bit for bit,
   the fits against a float64 numpy run of the two-shard step,
   ``keyed_aggregate`` against ``segment_sum_plain`` of each shard summed.
   Prints the fits' seconds with and without a mesh and the all-reduce's
   time a step at world 1 and 2; path J must launch ``spmv`` and
   ``segment_sum``;
6g. sharding plans, mixed precision, NaiveBayes and the graph API (path
   K): K1, ``init_distributed`` at world 1 over nccl, then
   ``LogisticRegression(sharding_plan=...)`` (momentum SGD) and
   ``train_linear_plan`` (Adam) under BATCH_PARALLEL, FSDP and FSDP_TP on
   path 5's data (1,000,000 x 123 float32, batch 262,144, 10 epochs,
   elastic net), the plans bit for bit with each other at world 1 and
   each against a float64 numpy run of the same plan steps;
   ``precision="mixed"`` against a numpy emulation of its bfloat16
   rounding (round to nearest even on the float32 bits) and against the
   float32 fit; ``dtype=bfloat16`` (FML601) and float64 (FML605) under
   ``mixed`` refused before any step or collective; the all-gather and
   all-reduce a step and their times; K2, in J2's two ranks over gloo,
   FSDP and FSDP_TP fits of the same rows with an intercept column (124
   wide), the ranks bit for bit, the 123-wide FSDP fit refused (FML502),
   an FSDP fit stopped at epoch ``K2_STOP`` by a scripted ``RankLost`` of
   rank 1 under a ``PreemptionWatchdog`` on both ranks (its terminal
   snapshot; ``plan_elastic_resume`` on rank 0 gives world 1 at that
   epoch), and that world-2 FSDP snapshot resumed at world 1 under
   ``rescale="reshard"``; K3, ``NaiveBayes`` on 2,000,000 rows of Adult's
   schema (8 categorical columns, age, education-num and hours-per-week
   as categories: 22 M cells counted by one ``segment_sum`` launch),
   counts, theta and pi equal to float64 numpy (``np.add.at``), the
   transform of 1,000,000 rows equal to the numpy argmax, the count's
   ``segment_sum`` against its plain version (and timed, with its bound
   and ``index_add_``); a ``GraphBuilder`` graph of StandardScaler ->
   LogisticRegression on the census rows through fit, transform, save,
   load and transform, equal to the same stages as a ``Pipeline``. Path K
   must launch ``segment_sum``;
6h. the streamed fits on several ranks (path L), in J2's two ranks over
   gloo, each rank feeding its own partition: L1, the streamed sparse
   ``LogisticRegression(mesh=...)`` at the Criteo profile (dim 1e6, 39
   draws), rank 0 with 4 batches of 65,536 rows and rank 1 with 3 of
   49,152 (padded rows and a dummy step), 2 epochs from a ``DataCache``
   per rank that spills half its batches, a snapshot every epoch into the
   shared directory, a run crashed by a scripted ``TornWrite`` of epoch
   2's commit (armed on both ranks; the torn directory never committed
   nor left behind) and resumed: the
   ranks bit for bit, the resumed fit within 1e-5 of the uninterrupted
   one, the fit against a float64 numpy run of the combined-step stream;
   the step's ``spmv`` and ``segment_sum`` on a rank's padded block and
   on a dummy block against their plain versions, timed beside their
   bounds; L2, a dense streamed LinearSVC at a9a's width; L3, a streamed
   KMeans at 784 wide (k = 10, 2 x 65,536 rows a rank, 2 epochs, k-means++ from the
   pooled reservoirs) against the port's one-process fit over the
   combined stream; L4, FTRL and OnlineKMeans over 8 x 16,384 rows a
   rank; L5, a world-2 rank-scoped snapshot resharded to world 1. Prints
   samples/s, the all-reduce a step, the feed's waits and the busy share;
   path L must launch ``spmv`` and ``segment_sum``;
6i. fault injection, the numerics sentinel and self-healing recovery
   (path M, ``faults_path``): M1, ``OnlineLogisticRegression.fit_stream``
   at path G's shape (64 x 16,384 x 123 float32) healed under two
   ``PoisonBatch``, a ``NaNGrad`` and a ``CorruptSnapshot`` of the
   NaNGrad's rollback target, equal bit for bit to its golden run (the
   stream without the three quarantined batches), and timed without a
   sentinel, with one every batch and with one every 8th, and the
   verdict alone traced by ``torch.profiler``; the time to recover from
   the ``recovery`` metrics group; M2, ``OnlineKMeans`` at
   I3's width (16 x 16,384 x 784, k = 10) healed under a ``NaNGrad``,
   equal to its golden run; M3, the streamed sparse LR at path E's
   Criteo profile fed as a ``Dataset`` of SparseVector rows (4 x 65,536
   rows, the CSR route), disarmed; one snapshotted epoch of it timed
   disarmed and under a plan that injects nothing (every seam calls it)
   in the order disarmed, armed, armed, disarmed (twice), the armed mean
   at least ``SEAM_FLOOR`` of the disarmed; under a
   ``DelayRead`` (epoch 0's feed wait), under a ``RaiseAtRead`` mid-ingest
   (the fit aborts), and from the sealed cache of the same batches killed
   after the epoch-2 commit, resumed within 1e-5 and its newest snapshot
   corrupted (``restore_latest`` walks back). Path M must launch ``spmv``
   and ``segment_sum``;
6j. the serving runtime (path N, ``serving_path``), at ``bench.py``'s
   serving widths with models the port fits on the card: N1, bench's
   five-stage chain (50,000 x 32 float64) behind one ``ServingEngine``
   (``max_batch_rows=256``, 1 ms window) that follows a ``ModelRegistry``,
   8 closed-loop clients sending 1-32 rows for 1 s: rows/s, the engine's
   and the clients' p50/p99, batch occupancy, no new program or kernel
   build after warmup; then 1 s more under ``torch.profiler``: the card's
   busy share and ``fused_chain``'s device time a batch beside the
   batch's wall time; N2, under the same load v2 (the chain refitted on
   data seed 1) published into the registry and ``rollback(1)``: every
   response its own version's, publish-to-first-v2 time and
   ``redispatched_for_version``; a ``DropPublish`` leaves the registry
   untouched and a NaN model is refused at publish and (published
   unchecked) at install while v1 serves; N1 and N2 launch
   ``fused_chain`` once a warmed bucket a full load plus once a batch;
   N3, one engine, then an 8-replica ``ReplicaPool`` on the one card
   (each replica its own CUDA stream) under FIFO and continuous batching,
   16 clients, ``max_batch_rows=128``, 2 ms window, 1 s each; N4, 4
   replicas over the chain at 20,000 rows under
   ``serving_grayfail_policy()`` with r1 stalled 0.2 s a batch: p99
   during the stall, time to quarantine, hedge wins, recovered p99 within
   max(2x baseline, baseline + 50 ms); N5, a 1-replica pool whose offered
   load triples, grown by a ``PoolAutoscaler``, then
   ``run_serving_soak(seed=7, budget=2)``. Every response is held against
   its version's float64 numpy chain (``rawPrediction`` within 1e-10,
   predictions away from 2^-5 of the decision);
6k. the cluster runtime (path O, ``cluster_path``), the chain of N1
   fitted again on the card: O1 (``bench.py``'s
   ``_multiproc_pool_stage``), an in-process ``ReplicaPool`` of 2 and a
   ``ClusterPool`` of 2 worker processes on the one card, 4 closed-loop
   clients of 1-32 rows for 1 s each (``max_batch_rows=128``, 2 ms
   window): rows/s, p50/p99, the workers-to-threads ratio, each worker's
   spawn ms and the transport p50/p99; the pool's responses bit for bit
   the in-process engine's on 4,096 rows, and each worker on ``cuda``
   with no ``nvcc`` run and its own ``fused_chain`` launches (read over
   the transport's ``stats``); O2, on those workers, a ``WorkerCrash``
   (exit 23) armed over the transport mid-traffic with zero requests
   lost and the survivor HEALTHY, ``respawn_dead()`` (no ``nvcc``, its
   predecessor's program count, flat under traffic, parity bit for bit),
   a lease acquired inside a worker reclaimed over the wire, and the
   metrics (2 workers alive, 3 ``spawn_ms``, a transport p99); O3,
   ``tests/_torch_elastic_rank.py`` as an ``ElasticProcessWorld`` of two
   gloo ranks on ``cuda:0`` that loses rank 1 to a ``WorkerCrash`` and
   resumes at world 1, bit for bit with a golden run;
6l. tensor parallelism and ring attention (path P, ``pr_ranks``): two
   gloo ranks spawned on the card (``--pr-rank``; ``send``/``recv`` and
   ``all_to_all`` staged through host memory) run a Transformer-base-like
   block in float32: ``tensor_parallel_mlp`` on [8192, 1024], d_ff 4096;
   ``expert_parallel_ffn`` and ``routed_expert_ffn`` with 2 experts (one a
   rank), 8,192 tokens, capacity 1.25; ``pipeline_parallel_apply`` over 2
   stages and 8 microbatches of [1024, 1024]; ``ring_attention`` and
   ``ulysses_attention`` on q, k, v [1, 16, 8192, 64], causal and not.
   The ranks agree bit for bit, each output within ``P_TOL`` of the
   largest magnitude of the same computation unsharded on the card; each
   call's ms and its collectives' share;
6m. ALS (path Q, ``als_path``, ``bench.py``'s ``_inner_als`` shape:
   16,384 x 16,384, 2^21 ratings in [1, 5], rank 32, seed 0): the first
   half-step against a float64 numpy solve (256 users); a 1-iteration
   fit against the ``cumsum`` layout's, and on the first 2^17 ratings
   against the CPU port's (rtol 5e-4, atol 5e-5); 3-iteration fits of both layouts (rating
   visits/s; training RMSE within 1e-4; ``cumsum`` bit for bit twice);
   the implicit mode; a streamed fit from a ``DataCache`` of 8 batches
   crashed after its epoch-1 snapshot and resumed; ``segment_sum`` at
   [65,536, 1,024] into 16,385 segments and ``recommend_for_all_users
   (10)``'s ``topk`` on [16,384, 16,384] against their plain versions
   and ``torch.topk``, with bounds; ``factor_tables()`` and the item
   factors served by an ``EmbeddingLookupModel`` behind a
   ``ServingEngine`` on a one-device mesh (4,096 rows within the
   ``mixed_inference`` tolerance). Q must launch ``segment_sum`` and
   ``topk``;
6n. sharded embeddings (path R, ``bench.py``'s
   ``_sharded_embedding_stage`` shape: vocab 2^20, dim 16, batch 2^13,
   8 reps): R1 at world 1 over nccl, FML503 refusing the replicated table
   and ``infer_plan`` finding no plan at 24 MB, the table replicated;
   R2 in path P's ranks, the table routed to the EMBEDDING plan at 96 MB
   (two shards); each strategy's lookup and update rows/s and
   ``exchange_bytes_per_step``, lookups and ``exchange.gather`` bit for
   bit with the dense gather, updates within 1e-5 of ``np.add.at``; the
   all_to_all scatter's local ``segment_sum`` with its masked rows on row
   0 and with them left out. R must launch ``segment_sum``;
6o. hashed features (path S, ``bench.py``'s ``_feature_freshness_stage``
   shape: 2^16 buckets, 512 rows x 4 ids, factor 16, 32 publishes):
   ``hash_buckets`` into a ``StreamingHashedFMTrainer`` on the card, a
   ``DeltaPublisher`` into a ``ModelRegistry``, a 2-replica
   ``ReplicaPool`` on the card following it by ``_try_delta_swap``; every
   answer bit for bit with its version's full snapshot; trainer rows/s,
   the delta-to-snapshot ratio, time to freshness p50/p99, delta swaps;
6p. the rest of the recsys family (path U, ``recsys_u_path``; U6 in
   :func:`pr_ranks`): U1, ``bench.py``'s ``_inner_word2vec`` shape (vocab
   32,768, dim 128, 2^20 uniform pairs, batch 8,192, 5 negatives, seed 0)
   through the port's ``_sgns_trainer``: the first 5 steps' updates from
   tables of 0.1 * normal at lr 64 within 1e-4 of the largest update of
   the CPU port's, pairs/s over 200 steps from bench.py's start;
   ``Word2Vec.fit`` on a seeded
   Zipf corpus over that vocab (about 2^20 pairs, 1 epoch) and
   ``find_synonyms(k=10)`` equal to ``torch.topk``'s scores. U2,
   ``FMClassifier`` at a9a's width (``make_data(1,000,000, 123)``, k = 8,
   batch 262,144): the first step within 1e-5 of the CPU port's, 200 Adam
   steps checked on accuracy; the sharded factor fit at world 1 on
   ``EMBEDDING`` within 1e-5 of the replicated one after 5 steps and
   agreeing on 99% of the predictions after 20; a float64 model (w of
   1e6, V of [1e6, 8]) on 262,144 Criteo rows x 39, its sparse margin
   within 1e-10 of float64 numpy. U3, ``MLPClassifier`` [784, 128, 10] on
   MNIST-width rows (scaled to [0, 1]): the first step within 1e-5 of the
   CPU port's, 200 steps, accuracy above chance by the JAX test's margin.
   U4, ``Tokenizer -> HashingTF(2^18) -> IDF -> LogisticRegression`` on
   100,000 seeded documents: the LR's coefficients within 1e-4 of the
   largest of a float64 numpy run of its 20 full-batch steps on the
   pipeline's TF-IDF rows, accuracy > 0.95. U5, the streamed Word2Vec
   (the Zipf corpus in 4 batches, lr 2.5) and FM (4 x 65,536 a9a rows)
   fits, 2 epochs, killed just after the epoch-1 snapshot commits and
   resumed: Word2Vec's epoch-2 update within 1e-4 of the uninterrupted
   run's, FM within 1e-5. U6, in P-R's two gloo ranks: the vocab-sharded
   trainer at vocab 2^18 + 1, both strategies, 20 steps from U1's check
   start, the ranks the same bits and the updates within 1e-4 of the
   largest of the unsharded run's on the card (the dense step for a data
   world of two). Afterwards, with the counters read: ``segment_sum`` at [8,192,
   128] and [40,960, 128] into 32,768 (uniform ids, and the Zipf
   corpus' unigram^0.75 pool), ``spmv`` float64 at 262,144 x 39, dim 1e6,
   and ``topk`` on [32,768] cosine scores, k = 10, each against its plain
   version with its bound and the library call's time. U must launch
   ``segment_sum``, ``spmv`` and ``topk``;
6q. the device half of the model catalog (path V, ``catalog_v_path``;
   V2's ranks in P-R's group): V1, ``GBTClassifier.fit`` at
   ``bench.py:456 _inner_gbt``'s shape (262,144 x 16 uniform rows, seed 0,
   y = x0·x1 > 0, 32 bins, depth 4, 20 trees, lr 0.2), with the
   ``segment`` layout (one ``segment_sum`` a level and one for the leaves)
   and the ``cumsum`` layout, the builder alone timed twice a layout
   (row-trees/s, ``bench.py``'s metric, and whether the two builds are
   the same bits), the card's forest held against the CPU port's by the
   near-tie rule (:func:`forest_parting`) over the CPU port's first 5
   trees (``V_CPU_TREES``, fitted beside the build) and their training
   accuracy within 0.005. V2, the streamed fit of the same rows in 4 batches, 5
   trees, subsample 0.8, exact edges, crashed after the snapshot of tree 3
   and resumed (the rule, and whether the resume is bit for bit), and over
   two gloo ranks on the card in P-R's group (each rank half of every
   batch, no subsampling; the same bits on both ranks, the rule against
   V1's first 5 trees). V3, ``RandomForestClassifier`` (10 trees, 4 of
   16 features, Poisson bagging) against the CPU port's first 5 trees,
   tree by tree; every tree's draws
   on the card equal to the CPU's, and the float32 ``log`` of all 2^23
   uniform values card against CPU. V4, ``GaussianMixture`` k = 8 on
   100,000 x 32 blobs, diag and full, 10 EM iterations, the mean
   log-likelihood within 1e-5 of float64 numpy EM from the same
   initialization. V5, ``PCA`` (k = 10) and ``Correlation`` at a9a's
   width (1,000,000 x 123, U2's rows) against float64 numpy (Spearman on
   a 100,000-row prefix). V6, ``PowerIterationClustering`` on 100,000
   vertices and 10^6 edges, 20 iterations, the iterate against float64
   numpy. V7, one fit and transform of each selector, ``KBinsDiscretizer``
   and ``AFTSurvivalRegression`` (against the CPU port). With the counters
   read: V1's level-0 histogram sum (4,194,304 ``[2]`` cells into 8,192
   segments, 512 hit) against its plain version, with its bound and
   ``index_add_``'s time. V must launch ``segment_sum``;
6r. the host half of the model catalog (path W, ``catalog_w_path``; its
   corpus, CPU-port references and Criteo-shaped columns made beside the
   build, :func:`w_references`): W1, ``LDA.fit`` (k = 20, 10 passes, tol
   0) on dense float32 counts resident on the card (4.48 GB) at the UCI
   "Bag of Words" Enron corpus' shape, 39,861 documents x 28,102 words,
   ~6.4 M tokens drawn from a seeded LDA process with 20 planted topics
   (Dirichlet 0.1 mixtures, Dirichlet 0.05 topics); the card's gamma draws
   within 10 ulps of the CPU's, its first VB pass on a 2,048-document prefix
   within 1e-4 of the CPU port's, the bound rising every pass, the fitted
   topics' mean matched cosine to the planted ones at least 0.8, and
   ``transform``; the streamed fit in 8 batches for 2 passes crashed after
   the pass-1 snapshot and resumed bit for bit. W2, ``OneVsRest`` over
   ``Pipeline(MinMaxScaler, LogisticRegression)`` on 60,000 x 784
   MNIST-like rows in 10 classes, its transform through ``fused_chain``
   (one launch a class), each class's ``rawPrediction``, fused and per
   stage, within 1e-5 of a float64 numpy sigmoid of its scaled rows,
   ``MulticlassClassificationEvaluator`` equal to float64 numpy within
   1e-12 and accuracy at least 0.9. W3, ``CrossValidator`` (3 folds) and
   ``TrainValidationSplit`` over LogisticRegression's regParam {100, 0,
   1000} at a9a's shape (32,561 x 123, columns of two scales, noisy planted
   labels), areaUnderROC within 1e-5 of the CPU port's and the same pick,
   which the CPU port's metrics decide by at least 1e-3. W4, 65,536
   Criteo-shaped rows (13 numeric columns with NaNs,
   card-resident, through ``Imputer``; 26 categorical string columns
   through ``StringIndexer`` capped at 10,000 values and its
   ``IndexToStringModel``) hashed by ``FeatureHasher`` into 2^18, then the
   sparse ``LogisticRegression`` fit (``spmv`` and ``segment_sum``) within
   1e-4 of the largest coefficient of float64 numpy, and its transform
   (``spmv``) within 1e-5 of a float64 numpy sigmoid of the CSR rows'
   margins. W5, every other new stage on a Table of card tensors, bit
   for bit against the same stage on host columns (the silhouette within
   1e-6). W must launch ``fused_chain``, ``spmv`` and ``segment_sum``;
6s. the compile cache, the tuning table and profiling (path X,
   ``compile_cache_path``, right after the kernel phase): X1, a fresh
   child (``--x1-child``) loads the four kernel libraries from the store
   with no ``nvcc`` run, serves the parent's saved chain from a
   ``ReplicaPool`` (the time from its spawn to its first prediction, the
   store's ``load_ms``), scales it to 3 replicas with no build, bit for
   bit, and holds ``spmv``, ``segment_sum``, ``topk`` and ``fused_chain``
   against their plain versions; X2, a child (``--x2-child``) on a copy
   of the store whose ``spmv`` is torn rebuilds it with one ``nvcc`` run
   (one corrupt entry) and holds it against the plain version, and an
   entry copied under another environment is refused; X3, the committed
   tuning table passes ``--check``, ``mesh_key()`` names this card, every
   consumer resolves to its entry, and one quick measurement
   (``gbt_histogram``) runs; X4, a ``trace`` of one served batch names
   the ``fused_chain`` kernel and a ``StepTimer`` of ``segment_sum``
   (2^26 cells) reads within 20% (or 20 µs) of CUDA events around the
   same steps. X1's and X2's children run beside X3.
6t. the static-analysis passes (path Y, ``analysis_path``, right after
   path X): Y1, ``bench.py:602``'s chain (4 scalers + LR, d = 32,
   float64) warmed at the 4,096-row bucket, then 8 transforms inside it
   and one across its boundary under a zero-budget
   ``TransferRetraceGuard``: no finding, no ``nvcc`` run, one
   ``fused_chain`` launch and one upload a transform, an unwarmed chain
   refused with FML402, the outputs within 1e-12 of the per-stage chain;
   Y2, the sorted-stream step (``_sorted_column_stepper``) captured at
   path H2's block (65,536 Criteo rows, dim 1e6, ELL width 64): one
   ``flinkml.segment_sum`` node, sorted, and no FML404, its ``False``
   copy one FML404; one step on the card launching what the capture
   shows, within 1e-5 of the step on CPU copies; Y3, the memory walker's
   peak for the dense step (1,000,000 x 123, batch 262,144) and the
   bucketed sparse step (262,144 Criteo rows) within 0.5x–2.0x of
   ``max_memory_allocated`` over one step, and FML701 at half of it.
   Prints one ``analysis:`` line. Y must launch ``fused_chain``, ``spmv``
   and ``segment_sum``;
6u. float16 in the four kernels (path Z, ``half_path``, right after path
   Y), under the policies a caller builds (no preset in either package:
   ``half_inference`` = float16 compute and accumulation, ``half`` =
   float16 compute, float32 accumulation): Z0, ``spmv`` at the fit shape,
   ``segment_sum`` unsorted and sorted at the fit step's cells (sorted
   bit for bit with the in-order float16 adds) and with a ``[2^20, 16]``
   payload, ``topk`` at the KNN chunk and on the adversarial rows, each
   against its plain version with its times, the library call's and the
   bound at 2 bytes a value; Z1, ``PipelineModel.transform`` under
   ``half_inference``, fused and per-stage, on the five-stage chain (one
   input past 65,504), the census pipeline, the MNIST-width multinomial
   and StandardScaler -> KMeans, each against float64 numpy on the
   float16-rounded inputs and constants (inf and NaN where it has them),
   and the KMeans chain under ``half`` refused with FML601 before any
   launch; Z2, the FSDP plan fit under ``half`` against its float16 numpy
   emulation and the float32 fit; Z3, float16 columns with no policy (a
   ``BatchedCSR`` batch's ``matvec`` and ``rmatvec``, ``Knn``, the fused
   KMeans transform) against float32 numpy; then ``fused_chain`` at Z1's
   three kernel shapes against the plain chain under ``half_inference``;
   then ``examples/train_logistic_regression_torch.py`` and
   ``examples/serve_pipeline_torch.py`` on the card as subprocesses. Z
   must launch all four kernels;
7. KNN path: ``Knn().fit`` on 60,000 x 784 float32 rows (integers 0-15),
   ``KnnModel.transform`` of 10,000 queries (k=5, 10 classes: three query
   chunks, three ``topk`` launches), the first 512 predictions equal to a
   float64 numpy brute force, and again with k=200; one chunk's product,
   distances and ``topk`` timed apart;
8. LSH path: ``MinHashLSH(numHashTables=5)`` on 65,536 Criteo-profile
   SparseVector rows (39 draws per row over 4,096 columns, so that rows
   overlap), transform, ``approx_nearest_neighbors(k=100)`` (one ``topk``
   launch) and ``approx_similarity_join`` at 2,000 x 2,000 rows, each equal
   to a numpy brute force;
9. KMeans paths: ``KMeans(maxIter=50)`` (100 until path U) at 65,536 x
   784, k=10 and
   262,144 x 128, k=64 on standard normal float32 points (twice, and the
   device loop alone), the objective below the init's; the same fits in
   float64 at 8 iterations (``KMEANS_CHECK_ITERS``; 100 until path K,
   15 until path U
   joined the run) against a float64 numpy Lloyd run from the same init
   (rtol 1e-4); ``BisectingKMeans(k=8)`` on 65,536 x 784 blobs against
   the CPU port.

Each path runs with the launch counters set to 0 just before it and read
just after; a path whose kernel never launched fails. The last lines are
the kernels' JSON summary (each kernel's record; ``bf16``, ``f16`` and,
for ``fused_chain``, ``tiers`` carry the bfloat16, float16 (path Z) and
path-D measurements;
``launches_by_path`` each path's launches),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --ab OTHER`` runs none of that: it times ``spmv``,
``topk``, ``segment_sum`` and ``fused_chain`` through the wrappers of the
checkout at OTHER (an unpacked ``git archive`` of another commit) and of
this one, each in its own process, in the order OTHER, this, this, OTHER,
and prints one JSON line per process after the card's line.
``--ab-stream OTHER`` does the same with path E's main fit
(:func:`ab_stream_inner`).

``python3 chip_smoke.py --o-scaleout`` runs none of that: path N3's load
against one engine, 8 in-process replicas and 8 worker processes on the
card (:func:`o_scaleout_main`); one JSON line.

``python3 chip_smoke.py --variants`` runs none of that either: it builds
edited copies of ``chain.cu`` and ``segsum.cu`` (:data:`VARIANTS`: a step
removed or a constant changed, to measure what each costs) and times each
through the port's wrappers; one JSON line per measurement.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from typing import Optional

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the vector
# (non-tensor-core) float32 / float64 rates, and the dense bfloat16 and
# float16 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12,
                  "float16": 989e12}

SPMV_ROWS, SPMV_DIM, SPMV_NNZ = 65_536, 1_000_000, 39
CHAIN_ROWS, CHAIN_D = 100_000, 32
# The fits: the bench's dense (a9a-width) and Criteo sparse workloads.
DENSE_FIT_ROWS, DENSE_FIT_D = 1_000_000, 123
SPARSE_FIT_ROWS = 262_144
FIT_BATCH, FIT_EPOCHS, FIT_LR = 262_144, 10, 0.1  # 20 until path U
PAYLOAD_CELLS, PAYLOAD_K, PAYLOAD_SEGMENTS = 1 << 20, 16, 65_536


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def make_criteo_csr(n, dim=1_000_000, nnz=39, seed=0, n_active=256):
    """Criteo-profile CSR (``nnz`` uniform-random columns per row over
    ``dim``), the generator of the repo's sparse benchmark."""
    rng = np.random.default_rng(seed)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, size=n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    active = rng.choice(dim, size=n_active, replace=False)
    beta = np.zeros(dim, dtype=np.float32)
    beta[active] = rng.normal(size=n_active)
    margins = (
        values.reshape(n, nnz) * beta[indices.reshape(n, nnz)]
    ).sum(axis=1)
    y = (margins > 0).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    return indptr, indices, values, y, w


#: :func:`make_data`'s draws by their arguments: paths 5, F, J, K and U2
#: fit the same rows, and nothing writes into them.
_DATA = {}


def make_data(n, dim, seed=0, dtype=np.float32):
    """Dense a9a-width data with planted labels, the generator of the
    repo's dense benchmark (drawn once for each set of arguments)."""
    key = (n, dim, seed, np.dtype(dtype).str)
    if key not in _DATA:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, dim)).astype(dtype)
        true_coef = rng.normal(size=dim).astype(dtype)
        y = (x @ true_coef > 0).astype(dtype)
        _DATA[key] = (x, y, np.ones(n, dtype=dtype))
    return _DATA[key]


def criteo_rows(indices, values, n, nnz, dim):
    """SparseVector rows of a ``make_criteo_csr`` draw; duplicate draws
    within a row merge by sum (CSR semantics)."""
    from flinkml_tpu_torch.linalg import SparseVector

    idx2 = indices.reshape(n, nnz)
    order = np.argsort(idx2, axis=1, kind="stable")
    si = np.take_along_axis(idx2, order, axis=1)
    sv = np.take_along_axis(values.reshape(n, nnz).astype(np.float64), order,
                            axis=1)
    first = np.ones((n, nnz), dtype=bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    starts = np.flatnonzero(first.reshape(-1))
    merged_i = si.reshape(-1)[starts].astype(np.int64)
    merged_v = np.add.reduceat(sv.reshape(-1), starts)
    bounds = np.concatenate([[0], np.cumsum(first.sum(axis=1))])
    rows = np.empty(n, dtype=object)
    for r in range(n):
        lo, hi = bounds[r], bounds[r + 1]
        rows[r] = SparseVector._from_sorted(dim, merged_i[lo:hi],
                                            merged_v[lo:hi])
    return rows


def bound_ms(n_bytes: float, n_ops, dtype: Optional[str]):
    """The least time of the work: its bytes over the memory rate, or its
    operations over the peak rate of their type (``n_ops`` a number of
    ``dtype`` operations, or a ``{dtype: operations}`` mapping with
    ``dtype`` None), whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    if dtype is None:
        t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in n_ops.items())
    else:
        t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Mean device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed (a 256 MB write) before every call so inputs come
    from device memory as they do on the main path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, warmup: int = 3, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e) for s, e in pairs]))


def timed_calls(torch, fn, calls: int = 3):
    """``(first_s, steady_s, result)``: host-clock seconds of a first call
    (set-up: uploads, program builds) and the mean of ``calls`` more, each
    ending in ``torch.cuda.synchronize()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(calls):
        result = fn()
    torch.cuda.synchronize()
    return first, (time.perf_counter() - t0) / calls, result


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def check_close(name, got, want, rtol, atol):
    torch = sys.modules["torch"]
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    if not torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol):
        fail(f"{name}: max abs err {max_err(got, want)} beyond "
             f"rtol={rtol} atol={atol}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# -- phase 2: kernels against their plain versions ------------------------------

def spmv_phase(torch, timer, rows=SPMV_ROWS):
    """``spmv`` at ``rows`` x 39 cells, dim 1e6: the serving shape (65,536
    rows) or the sparse fit's (262,144 rows)."""
    from flinkml_tpu_torch.kernels import spmv as kspmv

    indptr, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM,
                                                    SPMV_NNZ, seed=1)
    w_host = np.random.default_rng(2).normal(size=SPMV_DIM).astype(np.float32)
    idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
    val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).cuda()
    w = torch.from_numpy(w_host).cuda()
    got = kspmv.spmv(idx, val, w)
    again = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"spmv {rows} x {SPMV_NNZ}: two launches differ")
    want = kspmv.spmv_plain(idx, val, w)
    check_close("spmv vs plain", got, want, 1e-5, 1e-5)
    ref = (values.astype(np.float64).reshape(rows, SPMV_NNZ)
           * w_host.astype(np.float64)[indices.reshape(rows, SPMV_NNZ)]
           ).sum(axis=1)
    check_close("spmv vs float64 numpy", got, torch.from_numpy(ref).cuda(),
                1e-5, 1e-5)

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(), idx.reshape(-1).long(),
        val.reshape(-1), size=(rows, SPMV_DIM),
    )
    library_call = "torch.mv(sparse_csr_tensor, w)"
    library = lambda: torch.mv(csr, w)  # noqa: E731
    try:
        lib_out = library()
    except (RuntimeError, NotImplementedError):
        library_call = "torch.sparse.mm(sparse_csr_tensor, w[:, None])"
        library = lambda: torch.sparse.mm(csr, w[:, None])  # noqa: E731
        lib_out = library()
    check_close("spmv vs library", got, lib_out.reshape(-1), 1e-5, 1e-5)

    ms = timer(lambda: kspmv.spmv(idx, val, w))
    plain_ms = timer(lambda: kspmv.spmv_plain(idx, val, w))
    library_ms = timer(library)
    # Beside it: the same cells with gathers confined to 2,048 entries of w
    # (L1-resident: the cell stream's share), and the same number of random
    # gathers over the same dim with no cell stream (the gathers' floor).
    local = idx.remainder(2048)
    local_gather_ms = timer(lambda: kspmv.spmv(local, val, w))
    del local
    floor_out = torch.empty(val.numel() // 8 + 1, device="cuda")
    floor = probe_function("fml_gather_floor")
    stream = torch.cuda.current_stream().cuda_stream
    gather_floor_ms = timer(lambda: _build_check(floor(
        w.data_ptr(), SPMV_DIM, floor_out.data_ptr(), val.numel(), stream)))
    touched = np.unique(indices).size
    n_bytes = idx.numel() * 4 + val.numel() * 4 + touched * 4 + rows * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "float32")
    rec = {
        "name": "spmv", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/spmv.cu",
        "replaces": "flinkml_tpu/kernels/spmv.py:74",
        "shape": [rows, SPMV_NNZ, SPMV_DIM], "dtype": "float32",
        "max_abs_err": max_err(got, want), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": library_call, "repeatable": True,
        # Beside the HBM bound: each gather moves one 32-byte L2 sector.
        "gather_l2_bytes": val.numel() * 32,
        "local_gather_ms": local_gather_ms, "gather_floor_ms": gather_floor_ms,
    }
    log("kernel " + json.dumps(rec))
    return rec


def probe_function(symbol: str):
    """``symbol`` of a measurement probe in ``flinkml_tpu_torch/kernels/
    probes`` (built by ``_build.build_all`` with the kernels' ``nvcc``
    flags; not a kernel of the port): ``(out-or-input pointers..., n,
    stream)`` as its source says."""
    import ctypes

    from flinkml_tpu_torch.kernels import _build

    if symbol == "fml_gather_floor":
        args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
        return _build.function("gather_floor", symbol, args)
    return _build.function("red_floor", symbol, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


def _build_check(code):
    if code != 0:
        fail(f"floor probe: CUDA error {code}")


# Bucket widths the packer's DP picks (ops/sparse.py), and one wider than
# the kernel's 2,048-cell tile.
SPMV_WIDTHS = (1, 7, 39, 40, 1000, 3000)
SPMV_WIDTH_CELLS = 4 << 20


def spmv_widths_phase(torch):
    """``spmv`` at every width on a bucket view that starts one row in (off
    the 16-byte phase whenever the width is not a multiple of 4), float32
    and float64, the same bits on two launches. Widths up to 1,000: within
    rtol/atol 1e-5 of the plain version and of float64 numpy. The width
    past a tile (3,000 float32 terms a row, whose sums in two orders
    differ by more than 1e-5): within the summation error bound."""
    from flinkml_tpu_torch.kernels import spmv as kspmv

    for dtype in ("float32", "float64"):
        tdt = getattr(torch, dtype)
        for width in SPMV_WIDTHS:
            rows = SPMV_WIDTH_CELLS // width + 1
            rng = np.random.default_rng(width)
            idx_h = rng.integers(0, SPMV_DIM, size=(rows, width)).astype(np.int32)
            val_h = rng.normal(size=(rows, width)).astype(dtype)
            w_h = rng.normal(size=SPMV_DIM).astype(dtype)
            idx = torch.from_numpy(idx_h).cuda()[1:]
            val = torch.from_numpy(val_h).cuda()[1:]
            w = torch.from_numpy(w_h).cuda()
            got = kspmv.spmv(idx, val, w)
            again = kspmv.spmv(idx, val, w)
            torch.cuda.synchronize()
            label = f"spmv width {width} {dtype}"
            if not torch.equal(got, again):
                fail(f"{label}: two launches differ")
            terms = (val_h[1:].astype(np.float64)
                     * w_h.astype(np.float64)[idx_h[1:]])
            ref = torch.from_numpy(terms.sum(axis=1)).cuda()
            plain = kspmv.spmv_plain(idx, val, w)
            if width <= 1000:
                check_close(f"{label} vs plain", got, plain, 1e-5, 1e-5)
                check_close(f"{label} vs float64 numpy", got, ref, 1e-5, 1e-5)
                continue
            # Wider than a tile: a sum of `width` rounded terms, in any
            # order, is within gamma_width * sum|terms| of the exact sum
            # (recursive summation's error bound, unit roundoff u).
            u = float(np.finfo(dtype).eps) / 2
            gamma = width * u / (1 - width * u)
            bound = torch.from_numpy(gamma * np.abs(terms).sum(axis=1)).cuda()
            for name, other, scale in (("float64 numpy", ref, 1.0),
                                       ("plain", plain.double(), 2.0)):
                err = (got.double() - other).abs()
                if not bool(torch.all(err <= scale * bound)):
                    fail(f"{label} vs {name}: error beyond the summation "
                         f"bound (max err {float(err.max())})")
        log(f"spmv widths {list(SPMV_WIDTHS)} {dtype}: equal to plain and "
            "float64 numpy (1e-5; the summation bound past a tile), "
            "repeatable")


def chain_models(x, coef):
    """The five-stage chain with statistics computed in float64 numpy."""
    from flinkml_tpu_torch import (
        LogisticRegressionModel, MaxAbsScalerModel, MinMaxScalerModel,
        RobustScalerModel, StandardScalerModel, Table,
    )

    s = (x - x.mean(0)) / x.std(0)
    mn, mx = s.min(0), s.max(0)
    m = (s - mn) / (mx - mn)
    ma = np.abs(m).max(0)
    a = m / ma
    q = np.quantile(a, [0.25, 0.75], axis=0)
    stages = [
        StandardScalerModel().set_model_data(
            Table({"mean": x.mean(0)[None], "std": x.std(0)[None]})),
        MinMaxScalerModel().set_model_data(
            Table({"dataMin": mn[None], "dataMax": mx[None]})),
        MaxAbsScalerModel().set_model_data(Table({"maxAbs": ma[None]})),
        RobustScalerModel().set_model_data(
            Table({"median": np.median(a, 0)[None],
                   "range": (q[1] - q[0])[None]})),
    ]
    prev = "features"
    for i, st in enumerate(stages, start=1):
        st.set(st.INPUT_COL, prev).set(st.OUTPUT_COL, f"s{i}")
        prev = f"s{i}"
    lr = LogisticRegressionModel().set(LogisticRegressionModel.FEATURES_COL,
                                       prev)
    lr.set_model_data(Table({"coefficient": coef[None]}))
    return stages + [lr]


# Instructions of one IEEE division on the FMA pipes (a reciprocal
# estimate and its Newton steps, about 8 of them in float32 and float64):
# the estimate behind the chain's division floor.
DIV_INSTRUCTIONS = 8


def chain_phase(torch, timer, dtype, rtol, atol):
    """The five-stage chain at 100,000 x 32 on both routes, each against
    the plain chain: ``vector`` (the rule's pick for x as allocated) and
    ``scalar`` (the same rows one element into their buffer, off the
    16-byte alignment); the times of both routes, the plain chain's, the
    byte bound and the division floor."""
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.kernels import chain as kchain

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    coef = rng.normal(size=CHAIN_D)
    kernels = [s.transform_kernel() for s in chain_models(x, coef)]
    bucket = pipeline_fusion.row_bucket(CHAIN_ROWS)
    xp = torch.zeros((bucket, CHAIN_D), dtype=tdt, device="cuda")
    xp[:CHAIN_ROWS] = torch.from_numpy(x).to(device="cuda", dtype=tdt)
    outs = ["s4", "prediction", "rawPrediction"]
    program = kchain.ChainProgram(kernels, ["features"], outs)
    host_consts = tuple(k.constants for k in kernels)
    dev_consts = tuple({c: torch.as_tensor(v).cuda() for c, v in kc.items()}
                       for kc in host_consts)
    want = kchain.chain_plain(kernels, ["features"], outs, [xp], dev_consts,
                              CHAIN_ROWS)
    dot = torch.matmul(want["s4"][:CHAIN_ROWS].double(),
                       torch.from_numpy(coef).cuda())
    decisive = dot.abs() > 1e-4
    shifted = torch.empty(xp.numel() + 1, dtype=tdt, device="cuda")
    views = {"vector": xp, "scalar": shifted[1:].view(xp.shape)}
    views["scalar"].copy_(xp)
    err, route_ms = 0.0, {}
    for name, xv in views.items():
        if kchain.route(CHAIN_D, xv.element_size(), xv.data_ptr()) != name:
            fail(f"fused_chain[{dtype}]: the {name} view takes another route")
        got = program([xv], host_consts, CHAIN_ROWS)
        torch.cuda.synchronize()
        for c in ("s4", "rawPrediction"):
            check_close(f"fused_chain[{dtype}, {name}] {c}",
                        got[c][:CHAIN_ROWS], want[c][:CHAIN_ROWS], rtol, atol)
            err = max(err, max_err(got[c][:CHAIN_ROWS], want[c][:CHAIN_ROWS]))
        if not torch.equal(got["prediction"][:CHAIN_ROWS][decisive],
                           want["prediction"][:CHAIN_ROWS][decisive]):
            fail(f"fused_chain[{dtype}, {name}] prediction differs from plain")
        route_ms[name] = timer(lambda: program([xv], host_consts, CHAIN_ROWS))
    del shifted, views

    ms = route_ms["vector"]
    plain_ms = timer(lambda: kchain.chain_plain(
        kernels, ["features"], outs, [xp], dev_consts, CHAIN_ROWS))
    item = xp.element_size()
    n, d = CHAIN_ROWS, CHAIN_D
    table_bytes = (4 * (2 * d + 2) + d) * item
    n_bytes = n * d * item * 2 + n * item + 2 * n * item + table_bytes
    # Per element: Standard 2 (sub, div), MinMax 5 (sub, cmp, div, mul, add),
    # MaxAbs 1, Robust 1 (div), dot 2; per row ~5 for the sigmoid head.
    n_ops = n * d * 11 + n * 5
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    # Four of those ops are IEEE divisions of DIV_INSTRUCTIONS each; one
    # FMA-pipe instruction a lane per cycle is half the peak FLOP rate.
    div_floor_ms = (n * d * 4 * DIV_INSTRUCTIONS
                    / (PEAK_OPS_PER_S[dtype] / 2)) * 1e3
    rec = {
        "name": "fused_chain", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "flinkml_tpu/kernels/chain.py:173",
        "shape": [n, d], "dtype": dtype, "kernel_route": "vector",
        "max_abs_err": err, "ms": ms, "route_ms": route_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "division_floor_ms": div_floor_ms, "library_ms": None,
    }
    log("kernel " + json.dumps(rec))
    return rec


# -- phase 3: sparse LR serving path ---------------------------------------------

def sparse_path(torch):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.ops.sparse import sparse_margins

    n, dim, nnz = SPMV_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, _, _ = make_criteo_csr(n, dim, nnz, seed=0)
    coef = np.random.default_rng(4).normal(size=dim)
    model = fml.stage_from_arrays(
        "flinkml_tpu.models.logistic_regression.LogisticRegressionModel",
        fml.LogisticRegressionModel().get_param_map_json(),
        {"coefficient": coef},
    )
    rows = criteo_rows(indices, values, n, nnz, dim)
    idx2 = indices.reshape(n, nnz)
    val2 = values.reshape(n, nnz)
    table = fml.Table({"features": rows})
    ref = (val2.astype(np.float64)
           * coef.astype(np.float32).astype(np.float64)[idx2]).sum(axis=1)

    def run():
        (out,) = model.transform(table)
        return out.column("rawPrediction"), out.column("prediction")

    fml.reset_launch_counts()
    first_s, call_s, (raw, pred) = timed_calls(torch, run)
    launches = fml.launch_counts()["spmv"]
    if launches < 4:
        fail(f"sparse path: spmv launched {launches} times in 4 transforms")

    margins = sparse_margins(rows, coef)
    if not np.allclose(margins, ref, rtol=1e-5, atol=1e-5):
        fail("sparse path: margins differ from float64 numpy by "
             f"{np.abs(margins - ref).max()}")
    p_ref = 1.0 / (1.0 + np.exp(-ref))
    if raw.shape != (n, 2) or not np.isfinite(raw).all():
        fail(f"sparse path: rawPrediction shape {raw.shape} or non-finite")
    if not np.allclose(raw[:, 1], p_ref, rtol=1e-5, atol=1e-5):
        fail("sparse path: rawPrediction differs from float64 numpy")
    decisive = np.abs(ref) > 1e-4
    if not np.array_equal(pred[decisive], (ref[decisive] >= 0).astype(pred.dtype)):
        fail("sparse path: prediction differs from float64 numpy")
    rec = {"path": "sparse_lr_transform", "rows": n, "dim": dim,
           "transforms": 4, "first_call_s": first_s, "call_s": call_s,
           "rows_per_s": n / call_s, "spmv_launches": launches,
           "max_abs_margin_err": float(np.abs(margins - ref).max())}
    log("path " + json.dumps(rec))
    return launches


# -- phase 4: dense pipeline serving path ----------------------------------------

def numpy_chain(model, x):
    """Float64 numpy reference of the five-stage chain."""
    st, mm, ma, rb, lr = model.stages
    d = {k: np.asarray(v) for k, v in st._arrays().items()}
    s = (x - d["mean"]) / np.where(d["std"] > 0, d["std"], 1.0)
    d = mm._arrays()
    span = d["dataMax"] - d["dataMin"]
    s = np.where(span > 0, (s - d["dataMin"]) / np.where(span > 0, span, 1.0),
                 0.5)
    d = ma._arrays()
    s = s / np.where(d["maxAbs"] > 0, d["maxAbs"], 1.0)
    d = rb._arrays()
    s = s / np.where(d["range"] > 0, d["range"], 1.0)
    dot = s @ lr.coefficient
    p = 1.0 / (1.0 + np.exp(-dot))
    return s, dot, np.stack([1.0 - p, p], axis=-1)


def dense_path(torch):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    n, d = CHAIN_ROWS, CHAIN_D
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    train = fml.Table({"features": x, "label": y})
    stages, cur, prev = [], train, "features"
    for i, cls in enumerate((fml.StandardScaler, fml.MinMaxScaler,
                             fml.MaxAbsScaler, fml.RobustScaler), start=1):
        m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}").fit(cur)
        (cur,) = m.transform(cur)
        prev = f"s{i}"
        stages.append(m)
    xs = x.astype(np.float32)
    mean_ref = xs.astype(np.float64).mean(0)
    if not np.allclose(stages[0]._arrays()["mean"], mean_ref, rtol=1e-5,
                       atol=1e-6):
        fail("dense path: StandardScaler mean differs from numpy")
    lr = fml.LogisticRegressionModel().set(
        fml.LogisticRegressionModel.FEATURES_COL, prev)
    lr.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, d))}))
    model = fml.PipelineModel(stages + [lr])
    table = fml.Table({"features": x})

    def run():
        (out,) = model.transform(table)
        return {c: out.column(c) for c in ("s4", "prediction", "rawPrediction")}

    pipeline_fusion.set_enabled(True)
    fml.reset_launch_counts()
    first_s, call_s, fused = timed_calls(torch, run)
    launches = fml.launch_counts()["fused_chain"]
    if launches < 4:
        fail(f"dense path: fused_chain launched {launches} times in 4 "
             "transforms")

    pipeline_fusion.set_enabled(False)
    try:
        _, per_stage_s, per_stage = timed_calls(torch, run)
    finally:
        pipeline_fusion.set_enabled(True)
    for c, rtol in (("s4", 1e-12), ("rawPrediction", 1e-10)):
        if not np.allclose(fused[c], per_stage[c], rtol=rtol, atol=rtol):
            fail(f"dense path: fused {c} differs from per-stage by "
                 f"{np.abs(fused[c] - per_stage[c]).max()}")
    s_ref, dot_ref, raw_ref = numpy_chain(model, x)
    if not (np.allclose(fused["s4"], s_ref, rtol=1e-12, atol=1e-12)
            and np.allclose(fused["rawPrediction"], raw_ref, rtol=1e-10,
                            atol=1e-10)):
        fail("dense path: fused output differs from the float64 numpy chain")
    decisive = np.abs(dot_ref) > 1e-9
    if not np.array_equal(fused["prediction"][decisive],
                          (dot_ref[decisive] >= 0).astype(np.float64)):
        fail("dense path: prediction differs from the float64 numpy chain")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        model.save(path)
        loaded = fml.PipelineModel.load(path)
        (out,) = loaded.transform(table)
        for c in ("s4", "prediction", "rawPrediction"):
            if not np.array_equal(out.column(c), fused[c]):
                fail(f"dense path: {c} changed across save -> load")
    rec = {"path": "dense_pipeline_transform", "rows": n, "d": d,
           "dtype": "float64", "transforms": 4, "first_call_s": first_s,
           "fused_call_s": call_s, "fused_rows_per_s": n / call_s,
           "per_stage_call_s": per_stage_s,
           "per_stage_rows_per_s": n / per_stage_s,
           "fused_chain_launches": launches}
    log("path " + json.dumps(rec))
    return launches


# -- phase 2b: segment_sum against its plain version -----------------------------

def poison(torch, shape, tdt):
    """Leave a freed block of ``shape`` full of NaN in the caching
    allocator, so that an output the kernel fails to write shows as NaN."""
    torch.full(shape, float("nan"), dtype=tdt, device="cuda")
    torch.cuda.synchronize()


def segsum_case(torch, timer, ids_host, values_host, num_segments, dtype,
                sorted_ids, rtol, atol, red_floor=False):
    """One ``segment_sum`` case: kernel vs plain version on the card, the
    sorted path also bit for bit vs the in-order sum (``np.add.at``) on an
    output block poisoned with NaN, and the times; with ``red_floor``, the
    same number of random reductions into the same output size alone
    (``probes/red_floor.cu``)."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    tdt = getattr(torch, dtype)
    ids = torch.from_numpy(ids_host).cuda()
    ids_long = ids.long()
    vals = torch.from_numpy(values_host).to("cuda", tdt)
    out_shape = (num_segments,) + tuple(vals.shape[1:])
    poison(torch, out_shape, tdt)
    got = ksegsum.segment_sum(vals, ids, num_segments,
                              indices_are_sorted=sorted_ids)
    torch.cuda.synchronize()
    want = ksegsum.segment_sum_plain(vals, ids, num_segments)
    label = (f"segment_sum[{'sorted' if sorted_ids else 'unsorted'}, {dtype}, "
             f"k={1 if vals.dim() == 1 else vals.shape[1]}]")
    check_close(f"{label} vs plain", got, want, rtol, atol)
    bitwise = None
    if sorted_ids:
        in_order = np.zeros(tuple(got.shape), dtype=vals.cpu().numpy().dtype)
        np.add.at(in_order, ids_host, vals.cpu().numpy())
        bitwise = bool(np.array_equal(got.cpu().numpy(), in_order))
        if not bitwise:
            fail(f"{label}: the run-flush differs from the in-order sum")

    def library():
        return torch.zeros(tuple(got.shape), dtype=tdt,
                           device="cuda").index_add_(0, ids_long, vals)

    ms = timer(lambda: ksegsum.segment_sum(vals, ids, num_segments,
                                           indices_are_sorted=sorted_ids))
    plain_ms = timer(lambda: ksegsum.segment_sum_plain(vals, ids,
                                                       num_segments))
    library_ms = timer(library)
    item = vals.element_size()
    n_bytes = ids.numel() * 4 + vals.numel() * item + got.numel() * item
    b_ms, b_by = bound_ms(n_bytes, vals.numel(), dtype)
    rec = {
        "name": "segment_sum", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/segsum.cu",
        "replaces": "flinkml_tpu/kernels/segsum.py:222",
        "shape": [int(vals.shape[0]), int(got.numel() // num_segments),
                  num_segments],
        "dtype": dtype, "sorted": sorted_ids,
        "max_abs_err": max_err(got, want), "bitwise_in_order": bitwise,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library_call": "torch.zeros(...).index_add_(0, ids_int64, values)",
    }
    if red_floor:
        floor_out = torch.zeros(num_segments, dtype=tdt, device="cuda")
        floor = probe_function("fml_red_floor_f32" if dtype == "float32"
                               else "fml_red_floor_f64")
        stream = torch.cuda.current_stream().cuda_stream
        rec["red_floor_ms"] = timer(lambda: _build_check(floor(
            floor_out.data_ptr(), num_segments, vals.numel(), stream)))
        del floor_out
    log("kernel " + json.dumps(rec))
    return rec


def segsum_phase(torch, timer):
    """The sparse-fit step's scatter (Criteo cells into 1e6 segments) in
    float32 and float64, unsorted and sorted, and the row payload.
    Tolerances vs the plain version (``index_add_``, whose atomics also
    reorder the adds): float32 rtol/atol 1e-5, float64 1e-12."""
    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    sorted_order = np.argsort(indices, kind="stable")
    main = None
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        for sorted_ids in (False, True):
            ids = indices[sorted_order] if sorted_ids else indices
            vals = values[sorted_order] if sorted_ids else values
            rec = segsum_case(torch, timer, ids, vals.astype(dtype), SPMV_DIM,
                              dtype, sorted_ids, tol, tol,
                              red_floor=not sorted_ids)
            if dtype == "float32" and not sorted_ids:
                main = rec   # the fit's default layout
    rng = np.random.default_rng(6)
    ids = rng.integers(0, PAYLOAD_SEGMENTS, size=PAYLOAD_CELLS).astype(np.int32)
    vals = rng.normal(size=(PAYLOAD_CELLS, PAYLOAD_K)).astype(np.float32)
    for sorted_ids in (False, True):
        order = np.argsort(ids, kind="stable") if sorted_ids else slice(None)
        segsum_case(torch, timer, ids[order], vals[order], PAYLOAD_SEGMENTS,
                    "float32", sorted_ids, 1e-5, 1e-5)
    return main


# -- phase 2c: topk against its plain version ----------------------------------------

# (rows, n, k, dtype, why): the main shapes of the topk phase.
TOPK_CASES = (
    (4096, 60_000, 5, "float32", "one KNN chunk at MNIST width"),
    (1024, 8192, 16, "float32", "autotune/search.py:668"),
    (256, 2048, 128, "float32", "the Pallas kernel's MAX_K"),
    (None, 1_000_000, 100, "float64", "LSH-shaped 1-D"),
    (1024, 8192, 1024, "float32", "k past 128, one sort per row"),
    (None, 1_000_000, 20_000, "float64", "k past one sort: two bands"),
)
# (rows, n, k, dtype, routes): the same inputs through each route that
# takes them, timed in turns, for the rule in kernels/topk.py::route.
TOPK_ROUTE_CASES = (
    (4096, 60_000, 5, "float32", ("scan", "radix")),
    (4096, 60_000, 12, "float32", ("scan", "radix")),
    (4096, 60_000, 16, "float32", ("scan", "radix")),
    (1024, 8192, 16, "float32", ("fused", "scan", "radix")),
    (256, 2048, 32, "float32", ("fused", "radix")),
)


def topk_adversarial(dtype):
    """Small rows that pin the order: duplicates, +0 and -0, -inf-only
    rows, NaN of both signs, ascending and descending rows."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, size=(9, 67)).astype(dtype)
    x[1] = -np.inf
    x[2, ::2], x[2, 1::2] = 0.0, -0.0
    x[3, ::5] = np.nan
    neg_nan = np.frombuffer(
        np.array([0xFFF8000000000000], np.uint64).tobytes(), np.float64)[0]
    x[3, 1::7] = neg_nan
    x[4] = np.arange(67)
    x[5] = -np.arange(67)
    x[6, :60] = -np.inf
    x[7] = 1.0
    return x


def topk_check(torch, x, k, label):
    """Kernel vs plain, bitwise in values and indices; returns the kernel's
    result."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    got_v, got_i = ktopk.top_k(x, k)
    torch.cuda.synchronize()
    want_v, want_i = ktopk.top_k_plain(x, k)
    if got_v.shape != want_v.shape or got_i.dtype != torch.int32:
        fail(f"topk {label}: shape {tuple(got_v.shape)} / dtype {got_i.dtype}")
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    if not (torch.equal(got_i, want_i)
            and torch.equal(got_v.view(view), want_v.view(view))):
        bad = (got_i != want_i).nonzero()[:5].tolist()
        fail(f"topk {label}: differs from the plain version (first index "
             f"mismatches at {bad})")
    return got_v, got_i


def topk_phase(torch, timer):
    """``topk`` bit for bit against ``top_k_plain`` at the main paths'
    shapes and on adversarial rows; times of the kernel, the plain version
    and ``torch.topk`` (timed only)."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    for dtype in ("float32", "float64"):
        x = torch.from_numpy(topk_adversarial(dtype)).cuda()
        for k in (1, 10, 67):
            topk_check(torch, x, k, f"adversarial {dtype} k={k}")
        # One long row of the same values: split into segments.
        long = torch.from_numpy(topk_adversarial(dtype).reshape(-1)).cuda()
        topk_check(torch, x.reshape(-1), x.numel(),
                   f"adversarial whole {x.numel()}-element row {dtype}")
        long = long.repeat(500)
        for k in (1, 100, 128, 129, 20_000):
            topk_check(torch, long, k, f"adversarial 1-D {dtype} k={k} "
                       f"({ktopk.segments(1, long.numel())} segments)")
    rng = np.random.default_rng(9)
    recs = []
    for rows, n, k, dtype, why in TOPK_CASES:
        shape = (n,) if rows is None else (rows, n)
        if rows == 4096:
            # -d2 of integer features: integer values with many ties.
            host = -rng.integers(0, 176_401, size=shape).astype(dtype)
        elif rows is None:
            # -Jaccard distances: a few thousand distinct values.
            host = -np.round(rng.random(size=shape), 3).astype(dtype)
        else:
            host = rng.normal(size=shape).astype(dtype)
        x = torch.from_numpy(host).cuda()
        r = 1 if rows is None else rows
        route = ktopk.route(r, n, k, x.element_size())
        got_v, _ = topk_check(torch, x, k, f"{list(shape)} k={k} {dtype}")
        ms = timer(lambda: ktopk.top_k(x, k))
        plain_ms = timer(lambda: ktopk.top_k_plain(x, k))
        library_ms = timer(lambda: torch.topk(x, k, dim=-1))
        lib_v, _ = torch.topk(x, k, dim=-1)
        item = x.element_size()
        n_bytes = r * n * item + r * k * (item + 4)
        b_ms, b_by = bound_ms(n_bytes, r * n, dtype)
        rec = {
            "name": "topk", "route": "cuda",
            "source": "flinkml_tpu_torch/kernels/csrc/topk.cu",
            "replaces": "flinkml_tpu/kernels/topk.py:79",
            "shape": list(shape), "k": k, "dtype": dtype, "why": why,
            "kernel_route": route, "max_abs_err": 0.0,
            "library_values_equal": bool(torch.equal(lib_v, got_v)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "library_call": "torch.topk(x, k, dim=-1)",
        }
        log("kernel " + json.dumps(rec))
        recs.append(rec)
        del x
    topk_route_probe(torch, timer)
    return recs[0]


def topk_route_hosts():
    """The rows of :data:`TOPK_ROUTE_CASES`, drawn in the probe's order."""
    rng = np.random.default_rng(12)
    return [(-rng.integers(0, 176_401, size=(rows, n)).astype(dtype)
             if n == 60_000 else rng.normal(size=(rows, n)).astype(dtype))
            for rows, n, _, dtype, _ in TOPK_ROUTE_CASES]


def topk_route_probe(torch, timer):
    """Each of TOPK_ROUTE_CASES through every route that takes it, bit for
    bit against the plain version, timed in turns (forward, then back):
    the measurements behind the fixed rule in ``kernels/topk.py``."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    hosts = PREPARED.pop("topk_route_hosts", None) or topk_route_hosts()
    view = {"float32": torch.int32, "float64": torch.int64}
    for (rows, n, k, dtype, routes), host in zip(TOPK_ROUTE_CASES, hosts):
        x = torch.from_numpy(host).cuda()
        want_v, want_i = ktopk.top_k_plain(x, k)
        times = {r: [] for r in routes}
        for order in (routes, routes[::-1]):
            for r in order:
                got_v, got_i = ktopk.launch(x, k, r)
                torch.cuda.synchronize()
                if not (torch.equal(got_i, want_i) and torch.equal(
                        got_v.view(view[dtype]), want_v.view(view[dtype]))):
                    fail(f"topk route {r} [{rows}, {n}] k={k}: differs "
                         "from the plain version")
                times[r].append(timer(lambda: ktopk.launch(x, k, r)))
        rec = {"shape": [rows, n], "k": k, "dtype": dtype,
               "rule": ktopk.route(rows, n, k, x.element_size()),
               "ms": times}
        log("topk_route " + json.dumps(rec))
        del x, want_v, want_i


# -- phase 5: dense fit path --------------------------------------------------------

def numpy_dense_fit(x, y, w, seed, batch, epochs, lr, p=1):
    """Float64 numpy run of the dense trainer's steps (reg 0): the same
    seeded shuffle, the same rotating windows. With ``p`` shards (a mesh of
    p ranks) the rows pad to a multiple of p with weight 0, shard d holds
    the d-th block, each takes its own window of ``ceil(batch / p)`` rows,
    and a step sums every shard's gradient and weights."""
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    pad = -n % p
    x64 = np.concatenate([x[perm].astype(np.float64),
                          np.zeros((pad, x.shape[1]))])
    y64 = np.concatenate([y[perm].astype(np.float64), np.zeros(pad)])
    w64 = np.concatenate([w[perm].astype(np.float64), np.zeros(pad)])
    n_local = (n + pad) // p
    bs = min(-(-batch // p), n_local)
    n_windows = max(-(-n_local // bs), 1)
    coef = np.zeros(x.shape[1])
    for ep in range(epochs):
        start = min((ep % n_windows) * bs, n_local - bs)
        grad, wsum = np.zeros_like(coef), 0.0
        for d in range(p):
            lo = d * n_local + start
            xb, yb, wb = (a[lo:lo + bs] for a in (x64, y64, w64))
            ys = 2.0 * yb - 1.0
            mult = wb * (-ys / (1.0 + np.exp(xb @ coef * ys)))
            grad += xb.T @ mult
            wsum += wb.sum()
        coef = coef - lr / wsum * grad
    return coef


class _Epochs:
    """Listener: the last epoch a fit ran."""

    epoch = None

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epoch = epoch

    def on_iteration_terminated(self, state):
        pass


def dense_fit_path(torch):
    """Tolerance vs the float64 reference: 1e-4 of the largest
    coefficient (float32 products over 262,144 rows, 20 steps)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    x, y, w = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
    table = fml.Table({"features": x, "label": y})
    est = (fml.LogisticRegression().set_seed(0).set_tol(0.0)
           .set_global_batch_size(FIT_BATCH).set_max_iter(FIT_EPOCHS)
           .set_learning_rate(FIT_LR))
    fml.reset_launch_counts()
    first_s, fit_s, model = timed_calls(torch, lambda: est.fit(table), calls=2)
    counts = fml.launch_counts()
    coef = model.coefficient
    ref = numpy_dense_fit(x, y, w, 0, FIT_BATCH, FIT_EPOCHS, FIT_LR)
    err = float(np.abs(coef - ref).max())
    if (coef.shape != ref.shape or not np.isfinite(coef).all()
            or not err <= 1e-4 * np.abs(ref).max()):
        fail(f"dense fit: coefficient differs from float64 numpy by {err}")

    # The device loop alone, on data already on the card.
    xd, yd, wd = (torch.from_numpy(a).cuda() for a in (x, y, w))
    trainer = sgd._dense_trainer("logistic", FIT_BATCH)
    listener = _Epochs()
    _, loop_s, _ = timed_calls(torch, lambda: sgd._run_chunked(
        trainer, (xd, yd, wd), DENSE_FIT_D, torch.float32, FIT_LR, 0.0, 0.0,
        0.0, FIT_EPOCHS, listeners=[listener]))
    if listener.epoch != FIT_EPOCHS - 1:
        fail(f"dense fit: the device loop ran {listener.epoch} + 1 epochs")
    samples = FIT_BATCH * FIT_EPOCHS
    rec = {"path": "dense_lr_fit", "rows": DENSE_FIT_ROWS, "d": DENSE_FIT_D,
           "dtype": "float32", "batch": FIT_BATCH, "epochs": FIT_EPOCHS,
           "first_fit_s": first_s, "fit_s": fit_s,
           "samples_per_s": samples / fit_s, "device_loop_s": loop_s,
           "device_loop_samples_per_s": samples / loop_s,
           "host_s": fit_s - loop_s, "max_abs_coef_err": err,
           "max_abs_coef": float(np.abs(ref).max()), "launches": counts}
    log("path " + json.dumps(rec))


# -- phase 6: sparse fit path -----------------------------------------------------

def numpy_sparse_fit(indptr, indices, values, dim, y, w, epochs, lr):
    """Float64 numpy full-batch run of the sparse trainer's steps (reg 0;
    batch >= rows, so every bucket's window is the whole bucket). On a
    mesh of p ranks with batch >= rows every shard's window is its whole
    block, so the sum of the p shards' steps is this full-batch step."""
    n = indptr.size - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    v = values.astype(np.float64)
    y64, w64 = y.astype(np.float64), w.astype(np.float64)
    coef = np.zeros(dim)
    for _ in range(epochs):
        dot = np.bincount(rows, weights=v * coef[indices], minlength=n)
        ys = 2.0 * y64 - 1.0
        mult = w64 * (-ys / (1.0 + np.exp(dot * ys)))
        grad = np.bincount(indices, weights=v * mult[rows], minlength=dim)
        coef = coef - lr / w64.sum() * grad
    return coef


def sparse_fit_path(torch):
    """Tolerance vs the float64 reference: 1e-4 of the largest
    coefficient (float32 sums of ~10 cells per column and 39 per row,
    added by atomics in a run-dependent order on the unsorted path)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    n, dim, nnz = SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ
    if FIT_BATCH < n:
        fail("sparse fit: the full-batch numpy reference needs batch >= rows")
    _, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=0)
    table = fml.Table({"features": criteo_rows(indices, values, n, nnz, dim),
                       "label": y})
    est = (fml.LogisticRegression().set_seed(0).set_tol(0.0)
           .set_global_batch_size(FIT_BATCH).set_max_iter(FIT_EPOCHS)
           .set_learning_rate(FIT_LR))
    est.fit(table)   # first fit: kernel libraries load, allocator warms
    torch.cuda.synchronize()
    fml.reset_launch_counts()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = fml.launch_counts()
    if counts["segment_sum"] < FIT_EPOCHS or counts["spmv"] < FIT_EPOCHS:
        fail(f"sparse fit: kernel launches {counts} in one {FIT_EPOCHS}-epoch "
             "fit")

    _, csr_s, csr = timed_calls(
        torch, lambda: labeled_sparse_data(table, "features", "label"))
    indptr, cidx, cval, _, cy, cw = csr
    ref = numpy_sparse_fit(indptr, cidx, cval, dim, cy, cw, FIT_EPOCHS,
                           FIT_LR)
    errs = {"unsorted": float(np.abs(model.coefficient - ref).max())}

    fml.reset_launch_counts()
    t0 = time.perf_counter()
    coef_sorted = sgd.train_linear_model_sparse_csr(
        *csr[:4], cy, cw, "logistic", FIT_EPOCHS, FIT_LR, FIT_BATCH, 0.0, 0.0,
        0.0, 0, layout="sorted")
    torch.cuda.synchronize()
    sorted_fit_s = time.perf_counter() - t0
    sorted_counts = fml.launch_counts()
    errs["sorted"] = float(np.abs(coef_sorted - ref).max())
    for layout, err in errs.items():
        if not err <= 1e-4 * np.abs(ref).max():
            fail(f"sparse fit ({layout}): coefficient differs from float64 "
                 f"numpy by {err}")
    if sorted_counts["segment_sum"] < FIT_EPOCHS:
        fail(f"sparse fit (sorted): kernel launches {sorted_counts}")

    # Host packing apart from the device loop, for both layouts.
    split = {}
    for layout in ("unsorted", "sorted"):
        _, pack_s, (data_args, local_bss) = timed_calls(
            torch, lambda: sgd.prepare_sparse_buckets(
                *csr[:4], cy, cw, FIT_BATCH, seed=0, layout=layout))
        trainer = sgd._sparse_trainer_bucketed("logistic", local_bss, dim,
                                               layout)

        def loop():
            return sgd._run_chunked(trainer, data_args, dim, torch.float32,
                                    FIT_LR, 0.0, 0.0, 0.0, FIT_EPOCHS)

        _, loop_s, _ = timed_calls(torch, loop)
        split[layout] = {"pack_upload_s": pack_s, "device_loop_s": loop_s,
                         "buckets": len(local_bss),
                         "device_share": device_share(torch, loop)}
    samples = FIT_BATCH * FIT_EPOCHS
    rec = {"path": "sparse_lr_fit", "rows": n, "dim": dim, "nnz": nnz,
           "batch": FIT_BATCH, "epochs": FIT_EPOCHS, "fit_s": fit_s,
           "samples_per_s": samples / fit_s,
           "sorted_fit_s": sorted_fit_s,
           "sorted_samples_per_s": samples / sorted_fit_s,
           "csr_from_rows_s": csr_s, "split": split,
           "max_abs_coef_err": errs,
           "max_abs_coef": float(np.abs(ref).max()), "launches": counts,
           "sorted_launches": sorted_counts}
    log("path " + json.dumps(rec))
    return counts


# -- phase 7: KNN transform at MNIST width ----------------------------------------

KNN_TRAIN, KNN_QUERIES, KNN_D, KNN_CLASSES, KNN_K = 60_000, 10_000, 784, 10, 5
KNN_CHECK = 512
KNN_WIDE_K = 200


def numpy_knn(x, y, q, k):
    """Float64 numpy brute force: exact squared distances of integer
    features, a stable argsort (ties to the lower train index), a vote
    with ties to the smaller class."""
    classes, ids = np.unique(y, return_inverse=True)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d2 = ((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T)
          + (x64 * x64).sum(1)[None, :])
    nearest = np.argsort(d2, axis=1, kind="stable")[:, :k]
    votes = ids[nearest]
    counts = np.stack([np.bincount(v, minlength=len(classes)) for v in votes])
    return classes[np.argmax(counts, axis=1)]


def knn_path(torch, timer):
    """``Knn().fit`` on 60,000 x 784 rows and ``KnnModel.transform`` of
    10,000 queries, k=5, 10 classes, float32 features drawn as integers
    0-15 (distances exact in float32): three query chunks, the last
    partial. Predictions must equal the float64 numpy brute force on the
    first 512 queries exactly."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels.topk import top_k
    from flinkml_tpu_torch.ops import blas

    rng = np.random.default_rng(10)
    x = rng.integers(0, 16, size=(KNN_TRAIN, KNN_D)).astype(np.float32)
    y = rng.integers(0, KNN_CLASSES, size=KNN_TRAIN).astype(np.float64)
    q = rng.integers(0, 16, size=(KNN_QUERIES, KNN_D)).astype(np.float32)
    t0 = time.perf_counter()
    model = fml.Knn().set_k(KNN_K).fit(fml.Table({"features": x, "label": y}))
    fit_s = time.perf_counter() - t0
    queries = fml.Table({"features": q})

    def run():
        (out,) = model.transform(queries)
        return out.column("prediction")

    first_s, call_s, pred = timed_calls(torch, run, calls=2)
    fml.reset_launch_counts()
    pred = run()
    launches = fml.launch_counts()["topk"]
    chunks = -(-KNN_QUERIES // model.CHUNK)
    if launches != chunks:
        fail(f"knn: topk launched {launches} times for {chunks} chunks")
    want = numpy_knn(x, y, q[:KNN_CHECK], KNN_K)
    if pred.shape != (KNN_QUERIES,) or not np.array_equal(pred[:KNN_CHECK],
                                                          want):
        fail(f"knn: {int((pred[:KNN_CHECK] != want).sum())} of {KNN_CHECK} "
             "predictions differ from the float64 numpy brute force")

    # k past the Pallas kernel's 128 (the radix route: a row of distances
    # does not fit shared memory and k > 12), on the checked queries.
    model_wide = fml.Knn().set_k(KNN_WIDE_K).fit(
        fml.Table({"features": x, "label": y}))
    (out_wide,) = model_wide.transform(fml.Table({"features": q[:KNN_CHECK]}))
    want_wide = numpy_knn(x, y, q[:KNN_CHECK], KNN_WIDE_K)
    wide_diff = int((out_wide.column("prediction") != want_wide).sum())
    if wide_diff:
        fail(f"knn k={KNN_WIDE_K}: {wide_diff} of {KNN_CHECK} predictions "
             "differ from the float64 numpy brute force")

    # One full chunk's parts, on the card (CUDA events, L2 flushed).
    qc = torch.from_numpy(q[:model.CHUNK]).cuda()
    xt = torch.from_numpy(x).cuda()
    matmul_ms = timer(lambda: torch.matmul(qc, xt.T))
    distance_ms = timer(lambda: blas.squared_distances(qc, xt))
    neg = blas.squared_distances(qc, xt).neg_()
    topk_ms = timer(lambda: top_k(neg, KNN_K))
    del neg
    rec = {"path": "knn_transform", "train": KNN_TRAIN, "queries": KNN_QUERIES,
           "d": KNN_D, "k": KNN_K, "classes": KNN_CLASSES, "dtype": "float32",
           "chunk": model.CHUNK, "fit_s": fit_s, "first_call_s": first_s,
           "call_s": call_s, "queries_per_s": KNN_QUERIES / call_s,
           "chunk_matmul_ms": matmul_ms, "chunk_distance_ms": distance_ms,
           "chunk_topk_ms": topk_ms,
           "chunk_matmul_tflops": 2.0 * model.CHUNK * KNN_TRAIN * KNN_D
           / matmul_ms / 1e9,
           "device_share": device_share(torch, run),
           "topk_launches": launches, "checked_queries": KNN_CHECK,
           "checked_k": [KNN_K, KNN_WIDE_K]}
    log("path " + json.dumps(rec))
    return launches


# -- phase 8: MinHashLSH ----------------------------------------------------------

LSH_ROWS, LSH_DIM, LSH_TABLES, LSH_K = 65_536, 4_096, 5, 100
LSH_JOIN_ROWS, LSH_THRESHOLD = 2_000, 0.97


def numpy_minhash(a, b, indptr, flat, prime):
    """[rows, tables] min-hashes of CSR index sets (empty rows: prime)."""
    out = np.full((indptr.size - 1, a.size), prime, dtype=np.int64)
    h = (a[None, :] * (flat[:, None].astype(np.int64) + 1) + b[None, :]) % prime
    for r in range(indptr.size - 1):
        if indptr[r + 1] > indptr[r]:
            out[r] = h[indptr[r]:indptr[r + 1]].min(axis=0)
    return out


def lsh_path(torch, timer):
    """``MinHashLSH(numHashTables=5)`` on 65,536 Criteo-profile rows (39
    draws per row over 4,096 columns, so that rows overlap), transform,
    ``approx_nearest_neighbors(k=100)`` and ``approx_similarity_join`` at
    2,000 x 2,000 rows, each held against a numpy brute force."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels.topk import top_k
    from flinkml_tpu_torch.models.lsh import PRIME

    _, indices, values, _, _ = make_criteo_csr(LSH_ROWS, LSH_DIM, SPMV_NNZ,
                                               seed=11)
    rows = criteo_rows(indices, values, LSH_ROWS, SPMV_NNZ, LSH_DIM)
    sets = [v.indices[v.values != 0] for v in rows]
    lengths = np.array([len(r) for r in sets])
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    flat = np.concatenate(sets)
    table = fml.Table({"features": rows, "id": np.arange(LSH_ROWS)})
    est = (fml.MinHashLSH().set_input_col("features").set_output_col("hashes")
           .set_num_hash_tables(LSH_TABLES).set_seed(0))
    model = est.fit(table)
    t0 = time.perf_counter()
    (hashed,) = model.transform(table)
    transform_s = time.perf_counter() - t0
    want_h = numpy_minhash(model._a, model._b, indptr, flat, PRIME)
    if not np.array_equal(hashed.column("hashes"), want_h.astype(np.float64)):
        fail("lsh: transform hashes differ from numpy")

    key = rows[0]
    key_set = sets[0]
    fml.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nn = model.approx_nearest_neighbors(table, key, LSH_K)
    torch.cuda.synchronize()
    ann_s = time.perf_counter() - t0
    launches = fml.launch_counts()["topk"]
    cand = np.nonzero((want_h == want_h[0][None, :]).any(axis=1))[0]
    inter = np.bincount(np.repeat(np.arange(LSH_ROWS), lengths),
                        weights=np.isin(flat, key_set), minlength=LSH_ROWS)
    inter = inter.astype(np.int64)[cand]
    dists = 1.0 - inter / (lengths[cand] + key_set.size - inter)
    order = np.argsort(dists, kind="stable")[:LSH_K]
    if not (np.array_equal(nn.column("id"), cand[order])
            and np.array_equal(nn.column("distCol"), dists[order])):
        fail("lsh: approx_nearest_neighbors differs from the stable argsort")
    if launches != 1:
        fail(f"lsh: topk launched {launches} times in one query")
    neg = torch.from_numpy(-dists).cuda()
    topk_ms = timer(lambda: top_k(neg, min(LSH_K, dists.size)))

    n = LSH_JOIN_ROWS
    ta = fml.Table({"features": rows[:n]})
    tb = fml.Table({"features": rows[n:2 * n]})
    t0 = time.perf_counter()
    join = model.approx_similarity_join(ta, tb, LSH_THRESHOLD)
    join_s = time.perf_counter() - t0
    dense = np.zeros((2 * n, LSH_DIM), dtype=np.float32)   # exact counts
    dense[np.repeat(np.arange(2 * n), lengths[:2 * n]),
          flat[:indptr[2 * n]]] = 1.0
    inter2 = (dense[:n] @ dense[n:].T).astype(np.int64)
    union2 = lengths[:n, None] + lengths[None, n:2 * n] - inter2
    d2 = 1.0 - inter2 / union2
    shared = (want_h[:n, None, :] == want_h[None, n:2 * n, :]).any(axis=2)
    ia, ib = np.nonzero(shared & (d2 <= LSH_THRESHOLD))
    want_join = sorted(zip(ia.tolist(), ib.tolist(), d2[ia, ib].tolist()))
    got_join = sorted(zip(join.column("idA").tolist(),
                          join.column("idB").tolist(),
                          join.column("distCol").tolist()))
    if got_join != want_join or not got_join:
        fail(f"lsh: join has {len(got_join)} pairs, numpy {len(want_join)}")
    rec = {"path": "minhash_lsh", "rows": LSH_ROWS, "dim": LSH_DIM,
           "nnz": SPMV_NNZ, "tables": LSH_TABLES, "transform_s": transform_s,
           "transform_rows_per_s": LSH_ROWS / transform_s,
           "ann_k": LSH_K, "ann_candidates": int(cand.size), "ann_s": ann_s,
           "ann_topk_ms": topk_ms,
           "ann_host_s": ann_s - topk_ms / 1e3, "topk_launches": launches,
           "join_rows": [n, n], "join_threshold": LSH_THRESHOLD,
           "join_pairs": len(got_join), "join_s": join_s}
    log("path " + json.dumps(rec))
    return launches


# -- phase 9: KMeans fits -----------------------------------------------------------

# (rows, d, k, iterations): bench.py's kmeans_mnist and kmeans cells.
KMEANS_CELLS = ((65_536, 784, 10, 50), (262_144, 128, 64, 50))  # 100 until U
#: Lloyd iterations of the float64 check against numpy (the float32 fits
#: run the cells' 100): numpy's float64 steps took most of the path.
KMEANS_CHECK_ITERS = 8
BISECT_K = 8


def numpy_lloyd(x, centroids, max_iter):
    """Float64 numpy Lloyd steps (empty clusters keep their centroid).
    Once an assignment repeats, every later step reproduces the same
    centroids, so the loop stops there."""
    x = x.astype(np.float64)
    c = centroids.astype(np.float64)
    x2 = (x * x).sum(1)[:, None]
    prev = None
    for _ in range(max_iter):
        assign = np.argmin(x2 - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :],
                           axis=1)
        if prev is not None and np.array_equal(assign, prev):
            break
        prev = assign
        onehot = np.zeros((x.shape[0], c.shape[0]))
        onehot[np.arange(x.shape[0]), assign] = 1.0
        counts = onehot.sum(0)
        sums = onehot.T @ x
        c = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None],
                     c)
    return c


def inertia(x, c):
    """Sum of squared distances to the nearest centroid, in float64."""
    x = x.astype(np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]
    return float(np.maximum(d2.min(axis=1), 0.0).sum())


def kmeans_blobs(n, d, k, seed):
    """Float32 points (unit noise) around k centres 1,000 apart on each
    axis's scale: no point lies near a boundary between blobs, so two
    float32 runs that sum in different orders split the blobs alike."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 1000.0
    labels = rng.integers(0, k, size=n)
    return (centres[labels] + rng.normal(size=(n, d))).astype(np.float32)


def kmeans_path(torch):
    """``KMeans(k, maxIter=50).fit`` (random init, seed 0) at the bench's
    two shapes and on its data (standard normal float32): timed in float32,
    with the device loop timed alone; Lloyd's objective must fall from the
    init. The same fit on the same points in float64, at
    ``KMEANS_CHECK_ITERS`` iterations, is held against a float64 numpy
    Lloyd run from the same init (rtol 1e-4): a float32 run
    on points without cluster structure has points within rounding of a
    boundary, and one flip sends it down another path, so float32 is not
    compared with float64 step for step. Then ``BisectingKMeans(k=8)`` on
    MNIST-width blobs against the CPU port on the same data (equal
    predictions, centroids within 1e-10)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import kmeans as km

    recs = []
    for n, d, k, iters in KMEANS_CELLS:
        x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
        est = fml.KMeans().set_k(k).set_max_iter(iters).set_seed(0)
        table = fml.Table({"features": x})
        first_s, fit_s, model = timed_calls(torch, lambda: est.fit(table),
                                            calls=2)
        start = km.init_centroids(x, k, 0)
        got = model.centroids
        if got.shape != (k, d) or not np.isfinite(got).all():
            fail(f"kmeans {n}x{d} k={k}: centroids shape {got.shape} or "
                 "non-finite")
        before, after = inertia(x, start), inertia(x, got)
        if not after < before:
            fail(f"kmeans {n}x{d} k={k}: inertia {after} not below the "
                 f"init's {before}")
        xd, wd, _ = km.prepare_kmeans_data(x)
        c0 = torch.from_numpy(start).cuda()
        _, loop_s, _ = timed_calls(torch, lambda: km.lloyd(xd, wd, c0, iters),
                                   calls=2)
        share = device_share(torch, lambda: km.lloyd(xd, wd, c0, iters))
        del xd, wd

        x64 = x.astype(np.float64)
        est64 = fml.KMeans().set_k(k).set_max_iter(KMEANS_CHECK_ITERS) \
            .set_seed(0)
        t0 = time.perf_counter()
        got64 = est64.fit(fml.Table({"features": x64})).centroids
        fit64_s = time.perf_counter() - t0
        want = numpy_lloyd(x64, km.init_centroids(x64, k, 0),
                           KMEANS_CHECK_ITERS)
        err = float(np.abs(got64 - want).max())
        if not np.allclose(got64, want, rtol=1e-4, atol=1e-4):
            fail(f"kmeans {n}x{d} k={k} float64: centroids differ from "
                 f"numpy by {err}")
        rec = {"path": "kmeans_fit", "rows": n, "d": d, "k": k,
               "iterations": iters, "dtype": "float32", "init_mode": "random",
               "first_fit_s": first_s, "fit_s": fit_s,
               "points_per_s": n * iters / fit_s, "device_loop_s": loop_s,
               "device_loop_points_per_s": n * iters / loop_s,
               "host_s": fit_s - loop_s, "device_share": share,
               "inertia_init": before, "inertia_fit": after,
               "float64_fit_s": fit64_s,
               "float64_iterations": KMEANS_CHECK_ITERS,
               "float64_max_abs_centroid_err": err}
        log("path " + json.dumps(rec))
        recs.append(rec)

    n, d, _, _ = KMEANS_CELLS[0]
    x = kmeans_blobs(n, d, 10, seed=13)
    table = fml.Table({"features": x})
    est = fml.BisectingKMeans().set_k(BISECT_K).set_seed(0)
    t0 = time.perf_counter()
    gpu = est.fit(table)
    (pg,) = gpu.transform(table)
    gpu_s = time.perf_counter() - t0
    with fml.use_device("cpu"):
        cpu = est.fit(table)
        (pc,) = cpu.transform(table)
    if gpu.centroids.shape != (BISECT_K, d) or not np.array_equal(
            pg.column("prediction"), pc.column("prediction")) or \
            not np.allclose(gpu.centroids, cpu.centroids, rtol=1e-10,
                            atol=1e-10):
        fail("bisecting kmeans: the card's fit differs from the CPU port's")
    rec = {"path": "bisecting_kmeans_fit", "rows": n, "d": d, "k": BISECT_K,
           "fit_and_transform_s": gpu_s,
           "max_abs_centroid_err_vs_cpu": float(
               np.abs(gpu.centroids - cpu.centroids).max())}
    log("path " + json.dumps(rec))
    return recs


# -- the chain's prologue and class heads: kernel cases and paths A-C ---------------

#: UCI Adult's categorical columns with their cardinalities, "?" counted as
#: a category (archive.ics.uci.edu/dataset/2/adult), and its continuous
#: columns: the a9a source's schema.
ADULT_CATEGORICAL = (("workclass", 9), ("education", 16),
                     ("marital_status", 7), ("occupation", 15),
                     ("relationship", 6), ("race", 5), ("sex", 2),
                     ("native_country", 42))
ADULT_CONTINUOUS = ("age", "fnlwgt", "education_num", "capital_gain",
                    "capital_loss", "hours_per_week")
CENSUS_TRAIN, CENSUS_SERVE = 48_842, 100_000
MNIST_TRAIN, MNIST_SERVE, MNIST_D, MNIST_K = 60_000, 10_000, 784, 10
MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 8_192, 5, 0.1  # 20 until N, 10 until U
#: bench.py's two KMeans shapes, served through StandardScaler -> KMeans.
#: Path C: bench.py's two KMeans shapes, and MNIST's width with k = 64 (a
#: head too large for shared memory: its centroids are read from L2).
KMEANS_SERVE = ((65_536, 784, 10), (262_144, 128, 64), (65_536, 784, 64))
#: Relative gap of the two best scores under which a class or centroid
#: choice may break either way between two summation orders (float32).
NEAR_TIE = 1e-5

#: (op, rows, d, classes, dtype) of the kernel phase's new chain cases:
#: each op on the route its width gives (784 and 108 columns: scalar;
#: 32, 48 and 128 float32: vector; 128 float64: scalar). At 784 x k = 64
#: the centroids do not fit in shared memory beside the rows (read from
#: device memory).
CHAIN_OP_CASES = (
    ("multinomial", MNIST_SERVE, MNIST_D, MNIST_K, "float32"),
    ("multinomial", MNIST_SERVE, MNIST_D, MNIST_K, "float64"),
    ("multinomial", 100_000, 32, MNIST_K, "float32"),
    ("kmeans", 262_144, 128, 64, "float32"),
    ("kmeans", 262_144, 128, 64, "float64"),
    ("kmeans", 65_536, 784, 10, "float32"),
    ("kmeans", 65_536, 784, 64, "float32"),
    ("kmeans", 65_536, 784, 64, "float64"),
    ("prologue", CENSUS_SERVE, 108, 0, "float64"),
    ("prologue", CENSUS_SERVE, 48, 0, "float64"),
)


def census_columns(n, seed, cards=ADULT_CATEGORICAL, serve=False):
    """Seeded columns of UCI Adult's schema: the categorical codes (int64,
    int32 and float64 columns, every category present), the continuous
    columns at Adult's ranges, and a planted binary label. Serving draws
    add codes outside the fitted range (the catch-all slot)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i, (name, card) in enumerate(cards):
        codes = rng.integers(0, card, size=n)
        codes[:card] = np.arange(card)
        if serve:
            codes[::997] = card + 3
            codes[1::1009] = -1
        cols[name] = codes.astype((np.int64, np.int32, np.float64)[i % 3])
    cols["age"] = rng.integers(17, 91, size=n).astype(np.float64)
    cols["fnlwgt"] = np.round(rng.lognormal(12.0, 0.5, size=n))
    cols["education_num"] = rng.integers(1, 17, size=n).astype(np.float64)
    gain = rng.random(n) < 0.08
    cols["capital_gain"] = np.where(gain, rng.integers(1, 99_999, n), 0.0)
    loss = rng.random(n) < 0.05
    cols["capital_loss"] = np.where(loss, rng.integers(1, 4_356, n), 0.0)
    cols["hours_per_week"] = rng.integers(1, 100, size=n).astype(np.float64)
    score = ((cols["education_num"] - 10) / 3 + (cols["age"] - 40) / 15
             + (cols[cards[0][0]].astype(np.int64) % 3 == 0)
             + rng.normal(size=n))
    cols["label"] = (score > 0.5).astype(np.float64)
    return cols


def census_stages(cards=ADULT_CATEGORICAL, continuous=ADULT_CONTINUOUS):
    """OneHotEncoder(dropLast, keep) -> VectorAssembler(keep) ->
    StandardScaler -> LogisticRegression, unfitted."""
    import flinkml_tpu_torch as fml

    names = [c for c, _ in cards]
    onehot = [f"{c}_vec" for c in names]
    return [
        fml.OneHotEncoder().set_input_cols(names).set_output_cols(onehot)
        .set_drop_last(True).set_handle_invalid("keep"),
        fml.VectorAssembler().set_input_cols(onehot + list(continuous))
        .set_handle_invalid("keep").set_output_col("features"),
        fml.StandardScaler().set_input_col("features").set_output_col(
            "scaled"),
        fml.LogisticRegression().set_features_col("scaled").set_seed(0)
        .set_tol(0.0).set_max_iter(FIT_EPOCHS).set_global_batch_size(8_192)
        .set_learning_rate(0.5),
    ]


def numpy_census(model, cols, cards=ADULT_CATEGORICAL,
                 continuous=ADULT_CONTINUOUS):
    """Float64 numpy run of the fitted census model: one-hot (keep,
    dropLast), assemble, standardize, sigmoid; ``(features, scaled, dot,
    raw)``."""
    enc, _, sc, lr = model.stages
    parts = []
    for (name, _), mv in zip(cards, enc._max_indices):
        v = np.trunc(cols[name].astype(np.float64))
        valid = (v >= 0) & (v <= mv)
        slot = np.where(valid, v, mv).astype(np.int64)
        oh = np.zeros((v.size, mv + 1))
        oh[np.arange(v.size), slot] = 1.0
        oh[valid & (v == mv)] = 0.0
        parts.append(oh)
    parts += [cols[c].reshape(-1, 1) for c in continuous]
    x = np.concatenate(parts, axis=1)
    d = sc._arrays()
    std = np.where(d["std"] > 0, d["std"], 1.0)
    s = (x - d["mean"]) / std
    dot = s @ lr.coefficient
    p = 1.0 / (1.0 + np.exp(-dot))
    return x, s, dot, np.stack([1.0 - p, p], axis=-1)


def _gap_ok(scores, rel=NEAR_TIE):
    """Rows whose two best scores differ by more than ``rel`` relative."""
    top2 = np.sort(scores, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > rel * (1.0 + np.abs(top2[:, 1]))


def chain_op_case(torch, op, rows, d, k, dtype, seed=0):
    """One new chain op at its path's shape, its inputs on the card:
    ``(kernels, ext names, ext tensors, eager outputs, n_bytes, n_ops)``.
    multinomial: MinMaxScaler -> LR [k, d]; kmeans: StandardScaler ->
    KMeansModel [k, d]; prologue: OneHotEncoder -> VectorAssembler ->
    StandardScaler -> binomial LR over Adult's schema (d = 108), or over
    its first four categorical columns and one continuous column (d = 48,
    a vector-route row)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    if op == "prologue":
        cards = ADULT_CATEGORICAL if d == 108 else ADULT_CATEGORICAL[:4]
        cont = ADULT_CONTINUOUS if d == 108 else ADULT_CONTINUOUS[:1]
        fit_cols = census_columns(CENSUS_TRAIN, seed + 1, cards)
        cols = census_columns(rows, seed, cards, serve=True)
        enc, va, sc, _ = census_stages(cards, cont)
        with fml.use_device("cpu"):
            enc = enc.fit(fml.Table(fit_cols))
            (t,) = fml.PipelineModel([enc, va]).transform(
                fml.Table(fit_cols))
            sc = sc.fit(t)
        head = fml.LogisticRegressionModel().set_features_col("scaled")
        head.set_model_data(fml.Table({"coefficient": rng.normal(
            size=(1, d))}))
        stages = [enc, va, sc, head]
        body_ops = 2
    else:
        cols = {"features": rng.normal(size=(rows, d)) * 3.0}
        scaler = fml.MinMaxScaler() if op == "multinomial" \
            else fml.StandardScaler()
        scaler.set_input_col("features").set_output_col("s")
        with fml.use_device("cpu"):
            scaler = scaler.fit(fml.Table(cols))
        if op == "multinomial":
            head = fml.LogisticRegressionModel()
            head.set_model_data(fml.Table({"coefficient": rng.normal(
                size=(1, k, d))}))
        else:
            head = fml.KMeansModel().set_model_data(fml.Table(
                {"centroids": rng.normal(size=(1, k, d))}))
        head.set_features_col("s")
        stages = [scaler, head]
        body_ops = 5 if op == "multinomial" else 2
    kernels = [s.transform_kernel() for s in stages]
    ext = pipeline_fusion.external_inputs(kernels)
    bucket = pipeline_fusion.row_bucket(rows)
    vals, n_bytes = [], 0
    for c in ext:
        t = torch.from_numpy(np.ascontiguousarray(cols[c]))
        if t.dtype.is_floating_point:
            t = t.to(tdt)
        buf = torch.zeros((bucket,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device="cuda")
        buf[:rows] = t.cuda()
        vals.append(buf)
        n_bytes += t.numel() * t.element_size()
    pins = [c for kk in kernels if kk.pin_inputs for c in kk.input_cols]
    eager = pins + list(kernels[-1].output_cols)
    item = 8 if op == "prologue" else np.dtype(dtype).itemsize
    # Each output written once: the pinned row, then the head's.
    n_bytes += rows * d * item
    if op == "kmeans":
        n_bytes += rows * 8
        n_ops = rows * d * (body_ops + 2 * k)
    elif op == "multinomial":
        n_bytes += rows * item * (1 + k)
        n_ops = rows * d * (body_ops + 2 * k) + rows * k * 3
    else:
        n_bytes += rows * item * 3
        n_ops = rows * d * (body_ops + 2) + rows * 5
    return kernels, ext, vals, eager, n_bytes, n_ops


def chain_op_check(torch, label, kernels, got, want, rows, rel):
    """Every output of the kernel against the plain chain's: float columns
    within ``rel`` (rtol = atol), class and centroid indices equal away
    from near ties; returns ``(max_abs_err, rows inside the tie
    margin)``."""
    err, ties = 0.0, 0
    head = kernels[-1]
    for c, w in want.items():
        g, w = got[c][:rows], w[:rows]
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label} {c}: {g.dtype}{tuple(g.shape)} != "
                 f"{w.dtype}{tuple(w.shape)}")
        if c == head.output_cols[0] and head.fingerprint[0] in (
                "KMeansModel", "LogisticRegressionModel"):
            continue
        check_close(f"{label} {c}", g, w, rel, rel)
        err = max(err, max_err(g, w))
    name, pred = head.fingerprint[0], head.output_cols[0]
    if name in ("KMeansModel", "LogisticRegressionModel"):
        x = want[head.input_cols[0]][:rows].double()
        if name == "KMeansModel":
            c = torch.as_tensor(head.constants["centroids"]).cuda()
            scores = -(torch.cdist(x, c) ** 2)
        else:
            # Binomial: the scores of the two classes are -dot/2 and dot/2.
            w = torch.as_tensor(head.constants["coefficient"]).cuda()
            scores = x @ w.T if head.fingerprint[4] else \
                (x @ w)[:, None] * torch.tensor([-0.5, 0.5], device="cuda",
                                                dtype=x.dtype)
        ok = torch.from_numpy(_gap_ok(scores.cpu().numpy())).cuda()
        ties = int((~ok).sum())
        if not torch.equal(got[pred][:rows][ok], want[pred][:rows][ok]):
            fail(f"{label} {pred}: differs from the plain chain away from "
                 "near ties")
    return err, ties


def chain_ops_phase(torch, timer):
    """Each new ``fused_chain`` op (the multinomial head, the KMeans head,
    the one-hot + assemble prologue) at its path's shape on the route that
    shape takes, against the plain chain on the same card inputs, with the
    kernel's time, the plain chain's and the bound from bytes and
    operations. Tolerances: float64 rtol = atol 1e-10, float32 1e-5."""
    from flinkml_tpu_torch.kernels import chain as kchain

    recs = []
    for op, rows, d, k, dtype in CHAIN_OP_CASES:
        kernels, ext, vals, eager, n_bytes, n_ops = chain_op_case(
            torch, op, rows, d, k, dtype)
        program = kchain.ChainProgram(kernels, ext, eager)
        lay = program.layout(vals)
        host = [kk.constants for kk in kernels]
        dev = [{c: torch.as_tensor(v).cuda() for c, v in kc.items()}
               for kc in host]
        got = program(vals, host, rows)
        want = kchain.chain_plain(kernels, ext, eager, vals, dev, rows)
        torch.cuda.synchronize()
        label = f"fused_chain[{op} {rows}x{d} k={k} {dtype}]"
        rel = 1e-10 if lay.dtype == torch.float64 else 1e-5
        err, ties = chain_op_check(torch, label, kernels, got, want, rows,
                                   rel)
        ms = timer(lambda: program(vals, host, rows))
        plain_ms = timer(lambda: kchain.chain_plain(kernels, ext, eager,
                                                    vals, dev, rows))
        b_ms, b_by = bound_ms(n_bytes, n_ops, str(lay.dtype).replace(
            "torch.", ""))
        rec = {"name": "fused_chain", "op": op, "shape": [rows, d],
               "classes": k, "dtype": dtype, "kernel_route": lay.route,
               "gather": lay.gather, "max_abs_err": err,
               "near_ties": ties, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        log("kernel " + json.dumps(rec))
        recs.append(rec)
        del vals, got, want
    routes = {(r["op"], r["kernel_route"]) for r in recs}
    for op in ("multinomial", "kmeans", "prologue"):
        if {(op, "vector"), (op, "scalar")} - routes:
            fail(f"fused_chain {op}: not run on both routes")
    return recs


def segsum_descent_phase(torch, timer):
    """Sorted ``segment_sum`` on ids that do not ascend ([5, 2],
    [0, 0, 7, 1, 1] and 1e6 shuffled cells into 200,003 segments, flat and
    [cells, 16], float32 and float64): equal to ``index_add_`` (integer
    values, exact in any order) on an output block poisoned with NaN; the
    repair's time."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    rng = np.random.default_rng(11)
    shuffled = (rng.permutation(1_000_000) % 200_003).astype(np.int32)
    cases = (("5,2", np.array([5, 2], np.int32), 8),
             ("0,0,7,1,1", np.array([0, 0, 7, 1, 1], np.int32), 9),
             ("shuffled", shuffled, 200_003))
    rec = {"name": "segment_sum", "case": "descending ids", "checked": []}
    for label, ids, nseg in cases:
        for dtype in ("float32", "float64"):
            for k in (None, 16):
                sel = ids if k is None or ids.size < 100 else ids[:100_000]
                shape = (sel.size,) if k is None else (sel.size, k)
                tdt = getattr(torch, dtype)
                vals = torch.from_numpy(rng.integers(-8, 9, size=shape).astype(
                    np.float64)).to("cuda", tdt)
                ti = torch.from_numpy(sel).cuda()
                poison(torch, (nseg,) + tuple(vals.shape[1:]), tdt)
                got = ksegsum.segment_sum(vals, ti, nseg,
                                          indices_are_sorted=True)
                want = ksegsum.segment_sum_plain(vals, ti, nseg)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"segment_sum sorted on ids {label} ({dtype}, "
                         f"k={k}): differs from index_add_")
                rec["checked"].append([label, dtype, k])
    vals = torch.from_numpy(rng.normal(size=shuffled.size).astype(
        np.float32)).cuda()
    ti = torch.from_numpy(shuffled).cuda()
    rec["shuffled_1e6_f32_ms"] = timer(lambda: ksegsum.segment_sum(
        vals, ti, 200_003, indices_are_sorted=True))
    log("kernel " + json.dumps(rec))


def census_path(torch):
    """Path A: ``Pipeline.fit`` of OneHotEncoder -> VectorAssembler ->
    StandardScaler -> LogisticRegression on 48,842 rows of Adult's schema
    (the LR coefficient against a float64 numpy run of the same steps on
    the same scaled rows: 1e-8 of the largest), then the fused
    ``PipelineModel.transform`` of 100,000 rows with out-of-range codes,
    against the per-stage path and a float64 numpy run."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    train = census_columns(CENSUS_TRAIN, seed=21)
    first_s, fit_s, model = timed_calls(
        torch, lambda: fml.Pipeline(census_stages()).fit(fml.Table(train)),
        calls=1)
    enc, va, sc, lr = model.stages
    d = int(sum(enc._max_indices + 1)) + len(ADULT_CONTINUOUS)
    if d != 108 or lr.coefficient.shape != (d,):
        fail(f"census: width {d}, coefficient {lr.coefficient.shape}")
    pipeline_fusion.set_enabled(False)
    try:
        (seen,) = fml.PipelineModel([enc, va, sc]).transform(
            fml.Table(train))
        scaled = seen.column("scaled")
    finally:
        pipeline_fusion.set_enabled(True)
    ref = numpy_dense_fit(scaled, train["label"], np.ones(CENSUS_TRAIN), 0,
                          8_192, FIT_EPOCHS, 0.5)
    fit_err = float(np.abs(lr.coefficient - ref).max())
    if not fit_err <= 1e-8 * np.abs(ref).max():
        fail(f"census fit: coefficient differs from float64 numpy by "
             f"{fit_err}")

    serve = census_columns(CENSUS_SERVE, seed=22, serve=True)
    table = fml.Table(serve)
    outs = ("scaled", "prediction", "rawPrediction")

    def run():
        (out,) = model.transform(table)
        return {c: out.column(c) for c in outs}

    pipeline_fusion.reset_cache()
    fml.reset_launch_counts()
    t_first, call_s, fused = timed_calls(torch, run)
    launches = fml.launch_counts()["fused_chain"]
    if launches < 4:
        fail(f"census: fused_chain launched {launches} times in 4 transforms")
    (out,) = model.transform(table)
    lazy = {c: out.column(c) for c in ("workclass_vec", "features")}
    launches = fml.launch_counts()["fused_chain"]   # and 2 lazy reads
    # The transform alone (one launch, the outputs left on the card).
    _, transform_s, _ = timed_calls(torch, lambda: model.transform(table))
    pipeline_fusion.set_enabled(False)
    try:
        _, per_stage_s, per_stage = timed_calls(torch, run, calls=1)
    finally:
        pipeline_fusion.set_enabled(True)
    x, s, dot, raw = numpy_census(model, serve)
    for name, got in (("fused", fused), ("per-stage", per_stage)):
        if not (np.allclose(got["scaled"], s, rtol=1e-12, atol=1e-12)
                and np.allclose(got["rawPrediction"], raw, rtol=1e-10,
                                atol=1e-10)):
            fail(f"census: {name} output differs from float64 numpy")
    decisive = np.abs(dot) > 1e-9
    if not np.array_equal(fused["prediction"][decisive],
                          (dot[decisive] >= 0).astype(np.float64)):
        fail("census: prediction differs from float64 numpy")
    if not np.array_equal(lazy["features"], x):
        fail("census: the assembled row differs from numpy")
    rec = {"path": "census_pipeline", "train_rows": CENSUS_TRAIN,
           "serve_rows": CENSUS_SERVE, "d": d, "dtype": "float64",
           "first_fit_s": first_s, "fit_s": fit_s, "transforms": 4,
           "first_call_s": t_first,
           "fused_call_s": call_s, "fused_rows_per_s": CENSUS_SERVE / call_s,
           "fused_transform_only_s": transform_s,
           "per_stage_call_s": per_stage_s,
           "per_stage_rows_per_s": CENSUS_SERVE / per_stage_s,
           "max_abs_coef_err": fit_err,
           "catch_all_rows": int(sum((serve[c] < 0).sum()
                                     + (serve[c] >= k).sum()
                                     for c, k in ADULT_CATEGORICAL)),
           "fused_chain_launches": launches}
    log("path " + json.dumps(rec))
    return launches


def mnist_like(n, seed):
    """MNIST-width rows: 784 pixel intensities 0-255 (float32) drawn
    around ten seeded class templates, and their labels 0-9."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(99).integers(0, 256, (MNIST_K,
                                                            MNIST_D))
    y = rng.integers(0, MNIST_K, size=n)
    y[:MNIST_K] = np.arange(MNIST_K)
    x = np.clip(np.round(templates[y] + rng.normal(0, 70, (n, MNIST_D))),
                0, 255).astype(np.float32)
    return x, y.astype(np.float64)


def numpy_softmax_fit(x, y, seed, batch, epochs, lr, k):
    """Float64 numpy run of the softmax trainer's steps (reg 0, unit
    weights): the same seeded shuffle and rotating windows."""
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    x64, y64 = x[perm].astype(np.float64), y[perm].astype(np.int64)
    n_windows = max(-(-n // batch), 1)
    coef = np.zeros((k, x.shape[1]))
    for ep in range(epochs):
        start = min((ep % n_windows) * batch, n - batch)
        xb, yb = x64[start:start + batch], y64[start:start + batch]
        logits = xb @ coef.T
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        p[np.arange(yb.size), yb] -= 1.0
        coef = coef - lr / yb.size * (p.T @ xb)
    return coef


def mnist_path(torch):
    """Path B: ``Pipeline.fit`` of MinMaxScaler -> LogisticRegression
    (multinomial) on 60,000 x 784 rows in 10 classes on the card, the
    coefficient against a float64 numpy softmax run of the same steps on
    the same scaled rows (1e-4 of the largest: float32 products); the
    fused transform of 10,000 rows in float32 and float64 against the
    per-stage path and float64 numpy; one sparse multinomial transform of
    65,536 Criteo-profile rows with k = 10, the margins against float64
    numpy."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    x, y = mnist_like(MNIST_TRAIN, seed=31)
    est = [fml.MinMaxScaler().set_input_col("features").set_output_col("mm"),
           fml.LogisticRegression().set_features_col("mm")
           .set_multi_class("multinomial").set_seed(0).set_tol(0.0)
           .set_max_iter(MNIST_EPOCHS).set_global_batch_size(MNIST_BATCH)
           .set_learning_rate(MNIST_LR)]
    train = fml.Table({"features": x, "label": y})
    fit_first_s, fit_s, model = timed_calls(
        torch, lambda: fml.Pipeline(est).fit(train), calls=1)
    mm, lr = model.stages
    coef = lr.coefficient
    (seen,) = mm.transform(train)
    ref = numpy_softmax_fit(seen.column("mm"), y, 0, MNIST_BATCH,
                            MNIST_EPOCHS, MNIST_LR, MNIST_K)
    fit_err = float(np.abs(coef - ref).max())
    if coef.shape != (MNIST_K, MNIST_D) or not np.isfinite(coef).all() \
            or not fit_err <= 1e-4 * np.abs(ref).max():
        fail(f"mnist fit: coefficient {coef.shape} differs from float64 "
             f"numpy by {fit_err}")

    xs, _ = mnist_like(MNIST_SERVE, seed=32)
    d = mm._arrays()
    span = d["dataMax"] - d["dataMin"]
    unit = np.where(span > 0, (xs - d["dataMin"]) / np.where(span > 0, span,
                                                            1.0), 0.5)
    logits = unit @ coef.T
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    raw_ref = e / e.sum(axis=1, keepdims=True)
    decisive = _gap_ok(logits)
    launches, serve = 0, {}
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-10)):
        table = fml.Table({"features": xs.astype(dtype)})

        def run():
            (out,) = model.transform(table)
            return {c: out.column(c) for c in ("prediction", "rawPrediction")}

        pipeline_fusion.reset_cache()
        fml.reset_launch_counts()
        first_s, call_s, fused = timed_calls(torch, run)
        n_launch = fml.launch_counts()["fused_chain"]
        if n_launch < 4:
            fail(f"mnist serving ({dtype}): fused_chain launched {n_launch} "
                 "times in 4 transforms")
        launches += n_launch
        pipeline_fusion.set_enabled(False)
        try:
            _, per_stage_s, per_stage = timed_calls(torch, run, calls=1)
        finally:
            pipeline_fusion.set_enabled(True)
        for name, got in (("fused", fused), ("per-stage", per_stage)):
            if got["rawPrediction"].shape != (MNIST_SERVE, MNIST_K) or \
                    not np.allclose(got["rawPrediction"], raw_ref, rtol=tol,
                                    atol=tol):
                fail(f"mnist serving ({dtype}, {name}): rawPrediction "
                     "differs from float64 numpy")
            if not np.array_equal(got["prediction"][decisive],
                                  np.argmax(logits, 1)[decisive]):
                fail(f"mnist serving ({dtype}, {name}): prediction differs")
        serve[dtype] = {"first_call_s": first_s, "fused_call_s": call_s,
                        "fused_rows_per_s": MNIST_SERVE / call_s,
                        "per_stage_call_s": per_stage_s}

    n, dim, nnz = SPMV_ROWS, SPMV_DIM, SPMV_NNZ
    _, indices, values, _, _ = make_criteo_csr(n, dim, nnz, seed=3)
    sparse_coef = np.random.default_rng(5).normal(size=(MNIST_K, dim))
    sparse_model = fml.stage_from_arrays(
        "flinkml_tpu.models.logistic_regression.LogisticRegressionModel",
        fml.LogisticRegressionModel().get_param_map_json(),
        {"coefficient": sparse_coef})
    rows = criteo_rows(indices, values, n, nnz, dim)
    t0 = time.perf_counter()
    (sout,) = sparse_model.transform(fml.Table({"features": rows}))
    sparse_s = time.perf_counter() - t0
    c32 = sparse_coef.astype(np.float32).astype(np.float64).T
    margins = np.einsum("rs,rsk->rk", values.reshape(n, nnz).astype(
        np.float64), c32[indices.reshape(n, nnz)])
    m = margins - margins.max(axis=1, keepdims=True)
    sraw = np.exp(m) / np.exp(m).sum(axis=1, keepdims=True)
    got_raw = sout.column("rawPrediction")
    if got_raw.shape != (n, MNIST_K) or not np.allclose(
            got_raw, sraw, rtol=1e-4, atol=1e-5):
        fail("mnist sparse multinomial: rawPrediction differs from float64 "
             "numpy")
    rec = {"path": "mnist_multinomial", "train_rows": MNIST_TRAIN,
           "d": MNIST_D, "classes": MNIST_K, "batch": MNIST_BATCH,
           "epochs": MNIST_EPOCHS, "first_fit_s": fit_first_s,
           "fit_s": fit_s, "samples_per_s": MNIST_BATCH * MNIST_EPOCHS / fit_s,
           "max_abs_coef_err": fit_err,
           "max_abs_coef": float(np.abs(ref).max()),
           "serve_rows": MNIST_SERVE, "serve": serve,
           "sparse_rows": n, "sparse_dim": dim, "sparse_transform_s": sparse_s,
           "sparse_max_abs_raw_err": float(np.abs(got_raw - sraw).max()),
           "fused_chain_launches": launches}
    log("path " + json.dumps(rec))
    return launches


def kmeans_serving_path(torch):
    """Path C: StandardScaler -> KMeansModel fused at bench.py's two KMeans
    shapes and at MNIST's width with k = 64 (float32 standard normal
    points; centroids from a 10-iteration fit on the card): the fused
    transform's assignments against the plain chain's on the card, on
    every row whose two nearest squared distances differ by more than
    :data:`NEAR_TIE` relative (the count inside is printed), and against
    the per-stage path's. Both are timed reading the assignments back."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.kernels import chain as kchain

    launches, recs = 0, []
    for n, d, k in KMEANS_SERVE:
        x = np.random.default_rng(41).normal(size=(n, d)).astype(np.float32)
        table = fml.Table({"features": x})
        scaler = (fml.StandardScaler().set_input_col("features")
                  .set_output_col("s").fit(table))
        (scaled,) = scaler.transform(table)
        km = (fml.KMeans().set_k(k).set_max_iter(10).set_seed(0)
              .set_features_col("s").fit(scaled))
        model = fml.PipelineModel([scaler, km])

        def run():
            (out,) = model.transform(table)
            return out.column("prediction")

        pipeline_fusion.reset_cache()
        fml.reset_launch_counts()
        first_s, call_s, pred = timed_calls(torch, run)
        n_launch = fml.launch_counts()["fused_chain"]
        if n_launch < 4:
            fail(f"kmeans serving {n}x{d} k={k}: fused_chain launched "
                 f"{n_launch} times in 4 transforms")
        (out,) = model.transform(table)
        pipeline_fusion.set_enabled(False)
        try:
            _, per_stage_s, per_stage = timed_calls(torch, run, calls=1)
        finally:
            pipeline_fusion.set_enabled(True)
        launches += fml.launch_counts()["fused_chain"]
        kernels = [s.transform_kernel() for s in model.stages]
        xd = torch.from_numpy(x).cuda()
        want = kchain.chain_plain(kernels, ["features"], ["s", "prediction"],
                                  [xd], [kk.constants for kk in kernels], n)
        s_fused = out.column("s")
        if not np.allclose(s_fused, want["s"].cpu().numpy(), rtol=1e-5,
                           atol=1e-6):
            fail(f"kmeans serving {n}x{d}: scaled rows differ from plain")
        c = torch.from_numpy(km.centroids).cuda()
        d2 = (torch.cdist(want["s"].double(), c) ** 2).cpu().numpy()
        ok = _gap_ok(-d2)
        for name, got in (("fused", pred), ("per-stage", per_stage)):
            if got.dtype != np.int64 or not np.array_equal(
                    got[ok], want["prediction"].cpu().numpy()[ok]):
                fail(f"kmeans serving {n}x{d} k={k}: {name} assignments "
                     "differ from the plain chain away from near ties")
        rec = {"path": "kmeans_serving", "rows": n, "d": d, "k": k,
               "dtype": "float32", "transforms": 4, "first_call_s": first_s,
               "fused_call_s": call_s, "fused_rows_per_s": n / call_s,
               "per_stage_call_s": per_stage_s,
               "per_stage_rows_per_s": n / per_stage_s,
               "rows_within_tie_margin": int((~ok).sum()),
               "tie_margin_rel": NEAR_TIE,
               "fused_chain_launches": n_launch}
        log("path " + json.dumps(rec))
        recs.append(rec)
        del xd, want
    return launches


# -- path D: precision tiers --------------------------------------------------------

#: bench.py's ``_precision_stage`` chain: four scalers -> binomial LR.
PRECISION_ROWS, PRECISION_D = 65_536, 64
#: The tiers path D serves each case under (None: no policy).
PRECISION_CASES = (
    ("five_stage", (None, "mixed", "mixed_inference", "int8_inference")),
    ("census", ("mixed_inference", "int8_inference")),
    ("mnist", ("mixed_inference", "int8_inference")),
    ("kmeans", ("mixed_inference",)),
    # An int8 table larger than shared memory: the float table, its head
    # read from device memory.
    ("kmeans_wide", ("int8_inference",)),
)
#: The wide KMeans case: 65,536 x 784, k = 128.
KMEANS_WIDE = (65_536, 784, 128)
#: An LR decision within this margin of its boundary (the binomial
#: probability's 0.5, the two best classes' probabilities) may break either
#: way between the kernel's and the plain chain's summation orders at
#: bfloat16: such rows are counted, not held.
TIER_MARGIN = 2.0 ** -5
#: A KMeans assignment whose two best distances, as the plain chain rounds
#: them, lie within this many ulps of their dtype (at the second distance)
#: may break either way: the kernel rounds the same ops, each sum in
#: another order, so each distance may differ by an ulp.
KMEANS_TIER_ULPS = 2


def kmeans_near(torch, x, centroids, n_ulps=KMEANS_TIER_ULPS):
    """Rows whose assignment lies within ``n_ulps`` of a tie: the plain
    chain's distances (``ops/blas.py::squared_distances`` over ``x`` and
    ``centroids`` at their dtype) of the two best centroids within
    ``n_ulps`` ulps of the second one."""
    from flinkml_tpu_torch.ops import blas

    d2 = blas.squared_distances(x, centroids.to(x.dtype))
    top2 = torch.topk(d2.double(), 2, dim=1, largest=False).values
    fi = torch.finfo(d2.dtype)
    ulp = fi.eps * torch.exp2(torch.floor(torch.log2(
        top2[:, 1].clamp_min(fi.tiny))))
    return (top2[:, 1] - top2[:, 0]) <= n_ulps * ulp


def _eager_names(kernels):
    """The executor's eager outputs of a run (terminals and pins)."""
    from flinkml_tpu_torch import pipeline_fusion

    outs = pipeline_fusion._output_cols(kernels)
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    terminal = [c for c in outs if not any(
        c in kernels[j].input_cols for j in range(producer[c] + 1,
                                                  len(kernels)))]
    return list(pipeline_fusion._closure_outputs(kernels, terminal))


def _chain_ops(kernels, d, k):
    """Operations a row of the chain does, ``(body, head)``: scaler ops per
    element (Standard 2, MinMax 5, MaxAbs 1, Robust 1), then the head's
    dot(s) or distances."""
    per_elem = {"StandardScalerModel": 2, "MinMaxScalerModel": 5,
                "MaxAbsScalerModel": 1, "RobustScalerModel": 1}
    body = sum(per_elem.get(kk.fingerprint[0], 0) for kk in kernels) * d
    head = kernels[-1].fingerprint[0]
    if head == "KMeansModel":
        return body, 2 * k * d + 2 * d + 3 * k
    if head == "LogisticRegressionModel":
        return body, 2 * k * d + 4 * k if k else 2 * d + 5
    return body, 0


def tier_kernel_case(torch, timer, label, kernels, table, rows, policy):
    """The chain's eager program on the card under ``policy`` against the
    plain chain at the same policy on the same tensors: every output's
    dtype equal; values within the tier's tolerance (bfloat16 outputs one
    ulp, bfloat16 rawPrediction 2^-7, float16 outputs one ulp, float16
    rawPrediction 2^-9, float32 1e-5, float64 1e-10); the
    decisions equal outside the margin of their boundary (the rows inside
    counted): LR's :data:`TIER_MARGIN`, KMeans' :data:`KMEANS_TIER_ULPS`
    ulps of the plain chain's distances (:func:`kmeans_near`). Times: the
    wrapper under :class:`Timer`, the kernel's device time, the plain
    chain; the bound from the bytes read and written at each width and the
    operations at the row's type (the body) and the compute type (the
    head)."""
    from flinkml_tpu_torch import pipeline_fusion, precision
    from flinkml_tpu_torch.kernels import chain as kchain

    pol = precision.resolve_policy(policy)
    ext = pipeline_fusion.external_inputs(kernels)
    bucket = pipeline_fusion.row_bucket(rows)
    vals = [table.device_column_padded(c, bucket, "cuda") for c in ext]
    eager = _eager_names(kernels)
    consts = pipeline_fusion._tier_consts(kernels, pol)
    program = kchain.ChainProgram(kernels, ext, eager, pol)
    got = program(vals, consts, rows)
    want = kchain.chain_plain(kernels, ext, eager, vals, consts, rows, pol)
    torch.cuda.synchronize()
    err, near = 0.0, 0
    for c, g in got.items():
        g, w = g[:rows], want[c][:rows]
        if g.dtype != w.dtype:
            fail(f"{label}: {c} is {g.dtype}, the plain chain's {w.dtype}")
        if c == "prediction":
            continue
        if g.dtype == torch.bfloat16:
            tol = (2 ** -7, 2 ** -7) if c == "rawPrediction" else (2 ** -8, 0)
        elif g.dtype == torch.float16:
            tol = (2 ** -9, 2 ** -9) if c == "rawPrediction" else (2 ** -10, 0)
        elif g.dtype == torch.float32:
            tol = (1e-5, 1e-5)
        else:
            tol = (1e-10, 1e-10)
        check_close(f"{label} {c}", g.float() if g.element_size() == 2
                    else g, w.float() if w.element_size() == 2 else w,
                    *tol)
        err = max(err, max_err(g, w))
    g, w = got["prediction"][:rows], want["prediction"][:rows]
    if "rawPrediction" in want:
        top2 = torch.topk(want["rawPrediction"][:rows].double(), 2,
                          dim=1).values
        ok = (top2[:, 0] - top2[:, 1]) > TIER_MARGIN
    else:
        cen = consts[-1]["centroids"]
        cen = (kchain.boundary_const(pol, cen, "cuda")
               if pol is not None and pol.declared
               else torch.as_tensor(np.asarray(cen)).cuda())
        ok = ~kmeans_near(torch, want[kernels[-1].input_cols[0]][:rows], cen)
    near = int((~ok).sum())
    if not torch.equal(g[ok], w[ok]):
        fail(f"{label}: decisions differ from the plain chain away from the "
             f"margin ({near} rows near it)")
    ms = timer(lambda: program(vals, consts, rows))
    dev_ms = kernel_device_ms(torch, lambda: program(vals, consts, rows),
                              "fused_chain")
    plain_ms = timer(lambda: kchain.chain_plain(kernels, ext, eager, vals,
                                                consts, rows, pol))
    # The table the launch read: the int8 blob, or (an int8 table larger
    # than shared memory) the float table.
    tables = {key[0]: packed for key, (_, packed) in program._tables.items()}
    launched = (tables.get("_float") or tables["_table"])[0]
    table_bytes = launched.numel() * launched.element_size()
    n_bytes = (sum(v[:rows].numel() * v.element_size() for v in vals)
               + sum(o[:rows].numel() * o.element_size()
                     for o in got.values()) + table_bytes)
    lay = program._layout[1]
    k = kchain.head_classes(program.plan, consts)
    body, head = _chain_ops(kernels, lay.d, k)
    row_dt = str(lay.dtype).replace("torch.", "")
    ops = {row_dt: rows * body}
    compute = pol.compute if pol is not None and pol.declared else row_dt
    ops[compute] = ops.get(compute, 0) + rows * head
    b_ms, b_by = bound_ms(n_bytes, ops, None)
    return {"kernel_ms": ms, "kernel_device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": n_bytes, "row_dtype": str(lay.dtype).replace(
                "torch.", ""), "kernel_route": lay.route,
            "max_abs_err": err, "rows_near_boundary": near,
            "margin": (f"{KMEANS_TIER_ULPS} ulps" if "rawPrediction"
                       not in want else TIER_MARGIN)}


def _precision_models(torch, case):
    """``(model, serving table, rows)`` of one path-D case: the five-stage
    chain (statistics in float64 numpy, a seeded coefficient; float32
    rows); the census pipeline fitted as path A fits it, serving 100,000
    rows; MinMaxScaler -> multinomial LR at MNIST's width (k = 10,
    template classifier); StandardScaler -> KMeans (262,144 x 128, k = 64,
    or 65,536 x 784, k = 128; a 10-iteration fit)."""
    import flinkml_tpu_torch as fml

    if case == "five_stage":
        rng = np.random.default_rng(51)
        x = rng.normal(size=(PRECISION_ROWS, PRECISION_D))
        model = fml.PipelineModel(chain_models(
            x, rng.normal(size=PRECISION_D)))
        return model, fml.Table({"features": x.astype(np.float32)}), \
            PRECISION_ROWS
    if case == "census":
        train = census_columns(CENSUS_TRAIN, seed=21)
        model = fml.Pipeline(census_stages()).fit(fml.Table(train))
        serve = census_columns(CENSUS_SERVE, seed=22, serve=True)
        return model, fml.Table(serve), CENSUS_SERVE
    if case == "mnist":
        x, _ = mnist_like(MNIST_SERVE, seed=52)
        table = fml.Table({"features": x})
        mm = (fml.MinMaxScaler().set_input_col("features")
              .set_output_col("mm").fit(table))
        templates = np.random.default_rng(99).integers(0, 256, (MNIST_K,
                                                                MNIST_D))
        lr = fml.LogisticRegressionModel().set_features_col("mm")
        lr.set_model_data(fml.Table(
            {"coefficient": ((templates / 255.0 - 0.5) * 0.05)[None]}))
        return fml.PipelineModel([mm, lr]), table, MNIST_SERVE
    n, d, k = KMEANS_SERVE[1] if case == "kmeans" else KMEANS_WIDE
    x = np.random.default_rng(53).normal(size=(n, d)).astype(np.float32)
    table = fml.Table({"features": x})
    scaler = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(table))
    (scaled,) = scaler.transform(table)
    km = (fml.KMeans().set_k(k).set_max_iter(10).set_seed(0)
          .set_features_col("s").fit(scaled))
    return fml.PipelineModel([scaler, km]), table, n


def precision_path(torch, timer):
    """Path D: fused serving under the precision tiers at full width — the
    five-stage chain (65,536 x 64 float32) under no policy, ``mixed``,
    ``mixed_inference`` and ``int8_inference``; the census pipeline
    (100,000 rows, d = 108) and MNIST-width multinomial (10,000 x 784,
    k = 10) under ``mixed_inference`` and ``int8_inference``;
    StandardScaler -> KMeans (262,144 x 128, k = 64) under
    ``mixed_inference``, and under ``mixed`` refused with FML601 before
    any launch or program; StandardScaler -> KMeans at 65,536 x 784, k =
    128 under ``int8_inference`` (a table too large for shared memory).
    Each case: rows/s of ``transform`` reading
    ``prediction`` back (fused, and the per-stage path once per model),
    then :func:`tier_kernel_case`. Returns ``(fused_chain launches of the
    transforms, the per-case records)``."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    launches, recs = 0, []
    for case, tiers in PRECISION_CASES:
        model, table, rows = _precision_models(torch, case)

        def run():
            (out,) = model.transform(table)
            return out.column("prediction")

        pipeline_fusion.set_enabled(False)
        try:
            _, per_stage_s, _ = timed_calls(torch, run, calls=1)
        finally:
            pipeline_fusion.set_enabled(True)
        kernels = [s.transform_kernel() for s in model.stages]
        if case == "kmeans":
            pipeline_fusion.reset_cache()
            fml.reset_launch_counts()
            before = pipeline_fusion.compiled_program_count()
            try:
                with pipeline_fusion.precision_scope("mixed"):
                    run()
                fail("precision kmeans: mixed was not refused")
            except fml.PrecisionValidationError as e:
                rules = sorted({f.rule for f in e.findings})
            if (rules != ["FML601"]
                    or fml.launch_counts()["fused_chain"] != 0
                    or pipeline_fusion.compiled_program_count() != before):
                fail(f"precision kmeans: mixed refused with {rules}, "
                     f"{fml.launch_counts()['fused_chain']} launches, "
                     f"{pipeline_fusion.compiled_program_count() - before} "
                     "new programs")
            log("path " + json.dumps({"path": "precision", "case": case,
                                      "policy": "mixed", "refused": rules}))
        for policy in tiers:
            pipeline_fusion.reset_cache()
            fml.reset_launch_counts()
            with pipeline_fusion.precision_scope(policy):
                first_s, call_s, pred = timed_calls(torch, run, calls=20)
            n_launch = fml.launch_counts()["fused_chain"]
            if n_launch < 4 or pred.shape[0] != rows \
                    or not np.isfinite(pred).all():
                fail(f"precision {case} [{policy}]: {n_launch} launches, "
                     f"prediction {pred.shape} {pred.dtype}")
            launches += n_launch
            label = f"precision {case} [{policy}]"
            rec = {"path": "precision", "case": case, "policy": policy,
                   "rows": rows, "first_call_s": first_s,
                   "fused_call_s": call_s, "fused_rows_per_s": rows / call_s,
                   "per_stage_call_s": per_stage_s,
                   "per_stage_rows_per_s": rows / per_stage_s,
                   "prediction_host_dtype": str(pred.dtype),
                   "fused_chain_launches": n_launch}
            rec.update(tier_kernel_case(torch, timer, label, kernels, table,
                                        rows, policy))
            log("path " + json.dumps(rec))
            recs.append(rec)
        del model, table
    return launches, recs


# -- phase 2d: bfloat16 operands of spmv, segment_sum and topk -----------------------

def bf16_sum_check(torch, label, got, vals, ids, num_segments,
                   unit=2.0 ** -9):
    """A 16-bit segment sum in some order of its adds against the exact
    (float64) sum: each segment of ``c`` cells within ``min(c * u, 1)`` of
    the sum of its cells' magnitudes (the recursive-summation bound at the
    unit roundoff ``u``: 2^-9 for bfloat16, 2^-11 for float16) plus
    ``2u`` of the result."""
    exact = torch.zeros(num_segments, dtype=torch.float64).index_add_(
        0, ids.long(), vals.double())
    mag = torch.zeros(num_segments, dtype=torch.float64).index_add_(
        0, ids.long(), vals.double().abs())
    count = torch.bincount(ids.long(), minlength=num_segments).double()
    bound = torch.clamp(count * unit, max=1.0) * mag \
        + got.double().abs() * (2 * unit)
    if not bool(((got.double() - exact).abs() <= bound).all()):
        fail(f"{label}: beyond the summation bound of the exact sum")


def bf16_kernel_phase(torch, timer):
    """``spmv`` at the fit shape (262,144 x 39, dim 1e6), ``segment_sum``
    unsorted and sorted at the fit step's 10.2 M cells into 1e6 segments,
    ``topk`` at the KNN chunk [4096, 60000] k=5, all with bfloat16
    values: each against its plain version (``spmv``: float32 sums in
    another order, each rounded once: rtol 2^-7, atol 1e-2; sorted
    ``segment_sum`` bit for bit with the plain version's in-order adds on
    the CPU; unsorted within bf16 rounding of it; ``topk`` bit for bit),
    the times of the kernel, the plain version and the library call, the
    bound at 2 bytes a value. Returns ``{kernel name: [records]}``."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    out = {}
    rows = SPARSE_FIT_ROWS
    indptr, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM, SPMV_NNZ,
                                                    seed=1)
    idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
    val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).to(
        "cuda", torch.bfloat16)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=SPMV_DIM)).to("cuda", torch.bfloat16)
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    want = kspmv.spmv_plain(idx, val, w)
    check_close("spmv[bf16] vs plain", got.float(), want.float(), 2 ** -7,
                1e-2)
    library_call = "torch.mv(sparse_csr_tensor, w) [bfloat16]"
    try:
        csr = torch.sparse_csr_tensor(torch.from_numpy(indptr).cuda(),
                                      idx.reshape(-1).long(),
                                      val.reshape(-1), size=(rows, SPMV_DIM))
        torch.mv(csr, w)
        library_ms = timer(lambda: torch.mv(csr, w))
    except (RuntimeError, NotImplementedError) as e:
        library_ms, library_call = None, f"none: torch.mv refuses ({e})"[:200]
    touched = np.unique(indices).size
    n_bytes = idx.numel() * 4 + val.numel() * 2 + touched * 2 + rows * 2
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "bfloat16")
    out["spmv"] = [{
        "shape": [rows, SPMV_NNZ, SPMV_DIM], "dtype": "bfloat16",
        "max_abs_err": max_err(got, want),
        "ms": timer(lambda: kspmv.spmv(idx, val, w)),
        "plain_ms": timer(lambda: kspmv.spmv_plain(idx, val, w)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": library_call}]
    log("kernel_bf16 spmv " + json.dumps(out["spmv"][0]))
    del idx, val, w, got, want

    order = np.argsort(indices, kind="stable")
    out["segment_sum"] = []
    for sorted_ids in (False, True):
        ids_host = indices[order] if sorted_ids else indices
        vals_host = torch.from_numpy(
            values[order] if sorted_ids else values).to(torch.bfloat16)
        ids = torch.from_numpy(ids_host).cuda()
        vals = vals_host.cuda()
        poison(torch, (SPMV_DIM,), torch.bfloat16)
        got = ksegsum.segment_sum(vals, ids, SPMV_DIM,
                                  indices_are_sorted=sorted_ids)
        torch.cuda.synchronize()
        in_order = ksegsum.segment_sum_plain(
            vals_host, torch.from_numpy(ids_host), SPMV_DIM)
        label = f"segment_sum[bf16, {'sorted' if sorted_ids else 'unsorted'}]"
        if sorted_ids:
            if not torch.equal(got.cpu().view(torch.int16),
                               in_order.view(torch.int16)):
                fail(f"{label}: the run-flush differs from the in-order sum")
        else:
            bf16_sum_check(torch, label, got.cpu(), vals_host,
                           torch.from_numpy(ids_host), SPMV_DIM)
        ids_long = ids.long()
        n_bytes = ids.numel() * 4 + vals.numel() * 2 + SPMV_DIM * 2
        b_ms, b_by = bound_ms(n_bytes, vals.numel(), "bfloat16")
        rec = {"shape": [int(vals.shape[0]), 1, SPMV_DIM],
               "dtype": "bfloat16", "sorted": sorted_ids,
               "max_abs_err": max_err(got.cpu(), in_order),
               "ms": timer(lambda: ksegsum.segment_sum(
                   vals, ids, SPMV_DIM, indices_are_sorted=sorted_ids)),
               "plain_ms": timer(lambda: ksegsum.segment_sum_plain(
                   vals, ids, SPMV_DIM)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timer(lambda: torch.zeros(
                   SPMV_DIM, dtype=torch.bfloat16, device="cuda").index_add_(
                       0, ids_long, vals)),
               "library_call": "torch.zeros(...).index_add_ [bfloat16]"}
        log("kernel_bf16 segment_sum " + json.dumps(rec))
        out["segment_sum"].append(rec)
        del ids, vals, got, ids_long

    rows, n, k = 4096, 60_000, 5
    host = -np.random.default_rng(9).integers(0, 176_401, size=(rows, n))
    x = torch.from_numpy(host.astype(np.float32)).to("cuda", torch.bfloat16)
    got_v, _ = topk_check(torch, x, k, f"[{rows}, {n}] k={k} bfloat16")
    lib_v, _ = torch.topk(x, k, dim=-1)
    n_bytes = rows * n * 2 + rows * k * (2 + 4)
    b_ms, b_by = bound_ms(n_bytes, rows * n, "bfloat16")
    out["topk"] = [{
        "shape": [rows, n], "k": k, "dtype": "bfloat16",
        "kernel_route": ktopk.route(rows, n, k,
                                    ktopk.key_bytes(torch.bfloat16)),
        "max_abs_err": 0.0,
        "library_values_equal": bool(torch.equal(lib_v, got_v)),
        "ms": timer(lambda: ktopk.top_k(x, k)),
        "plain_ms": timer(lambda: ktopk.top_k_plain(x, k)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.topk(x, k, dim=-1)),
        "library_call": "torch.topk(x, k, dim=-1) [bfloat16]"}]
    log("kernel_bf16 topk " + json.dumps(out["topk"][0]))
    return out


# -- path Z: float16 in the four kernels, on float16-policy serving and fits ------

#: The float16 policies, built by the caller as the JAX package allows (no
#: preset in either package): float16 compute and accumulation for
#: serving, float16 compute with float32 accumulation for the trainer.
Z_HALF_INFERENCE = ("half_inference", "float16", "float16", "float32")
Z_HALF = ("half", "float16", "float32", "float32")
#: Z1: outputs against float64 numpy run on the float16-rounded inputs:
#: rawPrediction within Z_RAW_ATOL (each input and op rounds to float16,
#: 2^-11 relative, through up to four scalers and a 784-wide dot); a
#: decision is held where its float64 margin exceeds Z_MARGIN (the
#: binomial probability's distance from 0.5, the two best classes'
#: probabilities, the two best distances relative to the second); inf and
#: NaN where the reference has them (a value past 65,504 overflows).
Z_RAW_ATOL = 2.0 ** -6
Z_MARGIN = 2.0 ** -4
#: KMeans' decisions: the two best distances (~ 2 d in magnitude, each
#: within a few float16 ulps, 2^-10 relative) more than 2^-7 of the second
#: apart.
Z_KMEANS_MARGIN = 2.0 ** -7
#: Z1's five-stage serving rows: one input value past float16's 65,504.
Z_OVERFLOW_ROW, Z_OVERFLOW_VALUE = 3, 1.0e5
#: Z3: KNN at the KNN path's shape (60,000 x 784 train rows, one chunk of
#: queries) on MNIST-like intensities scaled to [0, 1] (their distances fit
#: float16); KMeans over a float16 column of blobs.
Z3_KNN_QUERIES = 4_096
Z3_KMEANS = (262_144, 128, 64)
#: Z0's topk: the KNN chunk (integer scores, many ties).
Z0_TOPK = (4_096, 60_000, 5)
#: The examples path Z runs on the card, and the token each prints last.
Z_EXAMPLES = ("train_logistic_regression_torch.py", "serve_pipeline_torch.py")
Z_EXAMPLE_TIMEOUT_S = 300


def z_policy(spec):
    import flinkml_tpu_torch as fml

    return fml.precision.PrecisionPolicy(*spec)


def half_kernel_phase(torch, timer):
    """Z0 (the kernels): ``spmv`` at the fit shape (262,144 x 39, dim 1e6),
    ``segment_sum`` unsorted and sorted at the fit step's 10.2 M cells
    into 1e6 segments and with a ``[2^20, 16]`` payload into 65,536
    segments, ``topk`` at the KNN chunk [4096, 60000] k=5 and on the
    adversarial rows, all float16: each against its plain version
    (``spmv``: float32 sums in another order, each rounded once: rtol
    2^-10, atol 1e-2; sorted ``segment_sum`` bit for bit with the plain
    version's in-order adds on the CPU; unsorted within the summation
    bound at float16's unit roundoff; ``topk`` bit for bit), the times of
    the kernel, the plain version and the library call, the bound at 2
    bytes a value. Returns ``{kernel name: [records]}``."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    f16 = torch.float16
    out = {}
    rows = SPARSE_FIT_ROWS
    indptr, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM, SPMV_NNZ,
                                                    seed=1)
    idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
    val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).to("cuda", f16)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=SPMV_DIM)).to("cuda", f16)
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    want = kspmv.spmv_plain(idx, val, w)
    check_close("spmv[f16] vs plain", got.float(), want.float(), 2 ** -10,
                1e-2)
    library_call = "torch.mv(sparse_csr_tensor, w) [float16]"
    try:
        csr = torch.sparse_csr_tensor(torch.from_numpy(indptr).cuda(),
                                      idx.reshape(-1).long(),
                                      val.reshape(-1), size=(rows, SPMV_DIM))
        torch.mv(csr, w)
        library_ms = timer(lambda: torch.mv(csr, w))
    except (RuntimeError, NotImplementedError) as e:
        library_ms, library_call = None, f"none: torch.mv refuses ({e})"[:200]
    touched = np.unique(indices).size
    n_bytes = idx.numel() * 4 + val.numel() * 2 + touched * 2 + rows * 2
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "float16")
    out["spmv"] = [{
        "shape": [rows, SPMV_NNZ, SPMV_DIM], "dtype": "float16",
        "max_abs_err": max_err(got, want),
        "ms": timer(lambda: kspmv.spmv(idx, val, w)),
        "plain_ms": timer(lambda: kspmv.spmv_plain(idx, val, w)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": library_call}]
    log("kernel_f16 spmv " + json.dumps(out["spmv"][0]))
    del idx, val, w, got, want

    order = np.argsort(indices, kind="stable")
    rng = np.random.default_rng(3)
    payload = rng.normal(size=(PAYLOAD_CELLS, PAYLOAD_K))
    payload_ids = rng.integers(0, PAYLOAD_SEGMENTS, size=PAYLOAD_CELLS)
    cases = []
    for sorted_ids in (False, True):
        cases.append((sorted_ids, indices[order] if sorted_ids else indices,
                      values[order] if sorted_ids else values, SPMV_DIM))
    pord = np.argsort(payload_ids, kind="stable")
    for sorted_ids in (False, True):
        cases.append((sorted_ids, (payload_ids[pord] if sorted_ids
                                   else payload_ids).astype(np.int32),
                      payload[pord] if sorted_ids else payload,
                      PAYLOAD_SEGMENTS))
    out["segment_sum"] = []
    for sorted_ids, ids_host, vals_np, nseg in cases:
        vals_host = torch.from_numpy(vals_np).to(f16)
        k = 1 if vals_host.dim() == 1 else vals_host.shape[1]
        ids = torch.from_numpy(ids_host).cuda()
        vals = vals_host.cuda()
        poison(torch, (nseg,) + tuple(vals.shape[1:]), f16)
        got = ksegsum.segment_sum(vals, ids, nseg,
                                  indices_are_sorted=sorted_ids)
        torch.cuda.synchronize()
        in_order = ksegsum.segment_sum_plain(
            vals_host, torch.from_numpy(ids_host), nseg)
        label = (f"segment_sum[f16, {'sorted' if sorted_ids else 'unsorted'}"
                 f", k={k}]")
        if sorted_ids:
            if not torch.equal(got.cpu().view(torch.int16),
                               in_order.view(torch.int16)):
                fail(f"{label}: the run-flush differs from the in-order sum")
        else:
            flat = (torch.from_numpy(ids_host).long()[:, None] * k
                    + torch.arange(k)).reshape(-1)
            bf16_sum_check(torch, label, got.cpu().reshape(-1),
                           vals_host.reshape(-1), flat, nseg * k,
                           unit=2.0 ** -11)
        ids_long = ids.long()
        n_bytes = ids.numel() * 4 + vals.numel() * 2 + nseg * k * 2
        b_ms, b_by = bound_ms(n_bytes, vals.numel(), "float16")
        rec = {"shape": [int(vals.shape[0]), k, nseg],
               "dtype": "float16", "sorted": sorted_ids,
               "max_abs_err": max_err(got.cpu(), in_order),
               "ms": timer(lambda: ksegsum.segment_sum(
                   vals, ids, nseg, indices_are_sorted=sorted_ids)),
               "plain_ms": timer(lambda: ksegsum.segment_sum_plain(
                   vals, ids, nseg)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timer(lambda: torch.zeros(
                   (nseg,) + tuple(vals.shape[1:]), dtype=f16,
                   device="cuda").index_add_(0, ids_long, vals)),
               "library_call": "torch.zeros(...).index_add_ [float16]"}
        log("kernel_f16 segment_sum " + json.dumps(rec))
        out["segment_sum"].append(rec)
        del ids, vals, got, ids_long

    rows, n, k = Z0_TOPK
    host = -np.random.default_rng(9).integers(0, 2_048, size=(rows, n))
    x = torch.from_numpy(host.astype(np.float16)).cuda()
    got_v, _ = topk_check(torch, x, k, f"[{rows}, {n}] k={k} float16")
    lib_v, _ = torch.topk(x, k, dim=-1)
    adv = torch.from_numpy(topk_adversarial(np.float64).astype(
        np.float16)).cuda()
    for kk in (1, 5, 66, 67):
        topk_check(torch, adv, kk, f"adversarial k={kk} float16")
    n_bytes = rows * n * 2 + rows * k * (2 + 4)
    b_ms, b_by = bound_ms(n_bytes, rows * n, "float16")
    out["topk"] = [{
        "shape": [rows, n], "k": k, "dtype": "float16",
        "kernel_route": ktopk.route(rows, n, k, ktopk.key_bytes(f16)),
        "max_abs_err": 0.0, "adversarial_rows_checked": True,
        "library_values_equal": bool(torch.equal(lib_v, got_v)),
        "ms": timer(lambda: ktopk.top_k(x, k)),
        "plain_ms": timer(lambda: ktopk.top_k_plain(x, k)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.topk(x, k, dim=-1)),
        "library_call": "torch.topk(x, k, dim=-1) [float16]"}]
    log("kernel_f16 topk " + json.dumps(out["topk"][0]))
    return out


def z_same(label, got, want, atol):
    """``got`` against the float64 reference ``want``: NaN and +-inf where
    the reference has them, the finite values within ``atol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64).reshape(got.shape)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        fail(f"{label}: NaN at {int((np.isnan(got) != np.isnan(want)).sum())}"
             " places where the float64 reference has none (or the reverse)")
    inf_g, inf_w = np.isinf(got) * np.sign(got), np.isinf(want) * np.sign(want)
    if not np.array_equal(np.nan_to_num(inf_g), np.nan_to_num(inf_w)):
        fail(f"{label}: inf differs from the float64 reference")
    fin = np.isfinite(want)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    if not err <= atol:
        fail(f"{label}: {err} from the float64 reference, beyond {atol}")
    return err, int((~fin).sum())


def z_decisions(label, got, want, decisive):
    """Decisions equal on the rows whose float64 margin is decisive;
    returns the count of rows inside the margin."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got[decisive], want[decisive]):
        bad = int((got[decisive] != want[decisive]).sum())
        fail(f"{label}: {bad} decisive rows differ from float64 numpy")
    return int((~decisive).sum())


def z1_reference(case, model, table):
    """Float64 numpy run of a Z1 chain on its float16-rounded inputs and
    model constants (the chain's boundary casts both to ``policy.compute``
    before the stages run, as the JAX package's ``_chain_fn`` does):
    ``(rawPrediction or None, prediction, decisive rows)``."""
    def r16(a):
        return np.asarray(a, np.float16).astype(np.float64)

    def std_scale(x, sc):
        d = sc._arrays()
        std = r16(d["std"])
        return (x - r16(d["mean"])) / np.where(std > 0, std, 1.0)

    cols = {c: (r16(v) if np.asarray(v).dtype.kind == "f" else np.asarray(v))
            for c, v in ((c, table.column(c)) for c in table.column_names)}
    if case == "five_stage":
        st, mm, ma, rb, lr = model.stages
        s = std_scale(cols["features"], st)
        d = mm._arrays()
        lo, span = r16(d["dataMin"]), r16(d["dataMax"]) - r16(d["dataMin"])
        s = np.where(span > 0, (s - lo) / np.where(span > 0, span, 1.0), 0.5)
        m = r16(ma._arrays()["maxAbs"])
        s = s / np.where(m > 0, m, 1.0)
        g = r16(rb._arrays()["range"])
        s = s / np.where(g > 0, g, 1.0)
        dot = s @ r16(lr.coefficient)
        p = 1.0 / (1.0 + np.exp(-dot))
        raw = np.stack([1.0 - p, p], axis=-1)
    elif case == "census":
        _, _, sc, lr = model.stages
        x = numpy_census(model, cols)[0]
        dot = std_scale(x, sc) @ r16(lr.coefficient)
        p = 1.0 / (1.0 + np.exp(-dot))
        raw = np.stack([1.0 - p, p], axis=-1)
    elif case == "mnist":
        mm, lr = model.stages
        d = mm._arrays()
        lo, span = r16(d["dataMin"]), r16(d["dataMax"]) - r16(d["dataMin"])
        s = np.where(span > 0, (cols["features"] - lo)
                     / np.where(span > 0, span, 1.0), 0.5)
        logits = s @ r16(lr.coefficient).T
        e = np.exp(logits - logits.max(1, keepdims=True))
        raw = e / e.sum(1, keepdims=True)
    else:
        sc, km = model.stages
        s = std_scale(cols["features"], sc)
        c = r16(km._arrays()["centroids"])
        d2 = ((s * s).sum(1)[:, None] - 2.0 * s @ c.T
              + (c * c).sum(1)[None])
        part = np.sort(d2, axis=1)
        decisive = ((part[:, 1] - part[:, 0])
                    > Z_KMEANS_MARGIN * np.abs(part[:, 1]))
        return None, np.argmin(d2, axis=1), decisive
    if raw.shape[1] == 2:
        pred = (raw[:, 1] >= 0.5).astype(np.float64)
        decisive = np.abs(raw[:, 1] - 0.5) > Z_MARGIN
    else:
        pred = np.argmax(raw, axis=1).astype(np.float64)
        top2 = np.sort(raw, axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > Z_MARGIN
    return raw, pred, decisive & np.isfinite(raw).all(1)


def z1_serving(torch):
    """Z1: ``PipelineModel.transform`` under ``half_inference``, fused
    (20 timed calls) and per-stage (one call), on the five-stage chain
    (65,536 x 64 float32; row 3 holds 1e5, past 65,504), the census
    pipeline (100,000 rows: Adult's fnlwgt, ~1.6e5 at the median, passes
    65,504 in most rows), the MNIST-width multinomial (10,000 x 784, k =
    10) and StandardScaler -> KMeans (262,144 x 128, k = 64), each against
    float64 numpy on the float16-rounded inputs and constants
    (:func:`z1_reference`, :func:`z_same`, :func:`z_decisions`; the
    per-stage path is timed only); the KMeans
    chain under ``half`` refused with
    FML601 before any launch or program. Returns ``(records, {case:
    (model, table, rows)})`` for Z0's kernel cases."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    pol = z_policy(Z_HALF_INFERENCE)
    recs, models = [], {}
    for case in ("five_stage", "census", "mnist", "kmeans"):
        model, table, rows = _precision_models(torch, case)
        models[case] = (model, table, rows)
        if case == "five_stage":
            x = np.array(table.column("features"))
            x[Z_OVERFLOW_ROW, 0] = Z_OVERFLOW_VALUE
            table = fml.Table({"features": x})

        def run(cols=("prediction", "rawPrediction")):
            (out,) = model.transform(table)
            return [out.column(c) for c in cols if c in out.column_names]

        pipeline_fusion.set_enabled(False)
        try:
            with pipeline_fusion.precision_scope(pol):
                _, per_stage_s, _ = timed_calls(torch, run, calls=1)
        finally:
            pipeline_fusion.set_enabled(True)
        pipeline_fusion.reset_cache()
        before = fml.launch_counts()["fused_chain"]
        with pipeline_fusion.precision_scope(pol):
            first_s, call_s, outs = timed_calls(torch, run, calls=20)
        n_launch = fml.launch_counts()["fused_chain"] - before
        if n_launch < 21:
            fail(f"half {case}: {n_launch} fused_chain launches for 21 calls")
        raw_want, pred_want, decisive = z1_reference(case, model, table)
        label = f"half {case} [half_inference]"
        pred = outs[0]
        rec = {"path": "half_Z1", "case": case, "policy": "half_inference",
               "rows": rows, "first_call_s": first_s, "fused_call_s": call_s,
               "fused_rows_per_s": rows / call_s,
               "per_stage_call_s": per_stage_s,
               "per_stage_rows_per_s": rows / per_stage_s,
               "prediction_host_dtype": str(pred.dtype),
               "fused_chain_launches": n_launch}
        if raw_want is not None:
            raw = outs[1]
            if raw.dtype != np.float16:
                fail(f"{label}: rawPrediction is {raw.dtype}")
            rec["raw_max_abs_err"], rec["raw_nonfinite"] = z_same(
                f"{label} rawPrediction", raw, raw_want, Z_RAW_ATOL)
        rec["rows_inside_margin"] = z_decisions(f"{label} prediction", pred,
                                                pred_want, decisive)
        if case == "kmeans":
            pipeline_fusion.reset_cache()
            before = fml.launch_counts()["fused_chain"]
            programs = pipeline_fusion.compiled_program_count()
            try:
                with pipeline_fusion.precision_scope(z_policy(Z_HALF)):
                    run()
                fail("half kmeans: the half policy was not refused")
            except fml.PrecisionValidationError as e:
                rules = sorted({f.rule for f in e.findings})
            if (rules != ["FML601"]
                    or fml.launch_counts()["fused_chain"] != before
                    or pipeline_fusion.compiled_program_count() != programs):
                fail(f"half kmeans: half refused with {rules}, "
                     f"{fml.launch_counts()['fused_chain'] - before} "
                     "launches")
            rec["half_refused"] = rules
        rec["card"] = card_line()
        log("path " + json.dumps(rec))
        recs.append(rec)
    return recs, models


def z2_plan_fit(torch):
    """Z2: ``train_linear_plan`` (FSDP plan, momentum SGD, path 5's data:
    1,000,000 x 123, batch 262,144) under ``half`` — the batch, ``coef``
    and the margin multiplier rounded to float16 at the step boundary, the
    products at float32 (``torch.matmul``) — against its float16 numpy
    emulation (1e-3 of the largest coefficient) and the float32 fit
    (different, within 2e-2)."""
    from flinkml_tpu_torch.sharding import PRESETS, train_linear_plan

    x, y, _ = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
    perm = np.random.default_rng(0).permutation(x.shape[0])
    xp, yp = x[perm], y[perm]
    windows = numpy_plan_windows(x, y, 0, FIT_BATCH)
    l2, l1 = K_REG * (1 - K_ELASTIC_NET), K_REG * K_ELASTIC_NET
    ref = numpy_plan_fit(windows, "sgd", FIT_EPOCHS, FIT_LR, 0.9, l2, l1,
                         mixed=f16_round)
    del windows
    plan = PRESETS["fsdp"]
    stats = {}
    secs, half = _seconds(torch, lambda: train_linear_plan(
        xp, yp, None, plan, None, precision=z_policy(Z_HALF), stats=stats,
        **k_kw()))
    full = train_linear_plan(xp, yp, None, plan, None, **k_kw())
    err = float(np.abs(half - ref).max())
    gap = float(np.abs(half - full).max())
    rec = {"path": "half_Z2", "plan": "fsdp", "policy": "half",
           "rows": DENSE_FIT_ROWS, "d": DENSE_FIT_D, "fit_s": secs,
           "loop_s": stats.get("loop_s"),
           "samples_per_s": FIT_BATCH * FIT_EPOCHS / secs,
           "max_abs_err_vs_f16_emulation": err,
           "max_abs_diff_vs_float32": gap,
           "max_abs_coef": float(np.abs(ref).max()), "card": card_line()}
    log("path " + json.dumps(rec))
    if not (np.isfinite(half).all() and err <= 1e-3 * np.abs(ref).max()):
        fail(f"half Z2: the half fit differs from its numpy emulation by {err}")
    if not 0.0 < gap <= 2e-2:
        fail(f"half Z2: the half fit is {gap} from the float32 fit")
    return rec


def z3_columns(torch):
    """Z3: float16 feature columns with no policy (the port computes in the
    column's dtype): a float16 sparse batch (``BatchedCSR`` at the fit
    shape, 262,144 x 39, dim 1e6: the margins by ``spmv`` within one
    float16 ulp plus 2^-11 of each row's sum of |products|, the gradient
    scatter by ``segment_sum`` within the summation bound, both against
    float32 numpy on the float16 cells); ``Knn`` at 60,000 x 784 train
    rows and a chunk of 4,096 queries (intensities / 255, as float16: on
    the first 512, predictions equal the float32 numpy brute force's on
    99% and on every query whose 5th and 6th distances differ by more
    than 2^-4); the fused StandardScaler -> KMeans transform of a float16
    column of blobs (262,144 x 128, k = 64; a run of two stages, so the
    executor fuses it: assignments equal float32 numpy's where the two
    best distances differ by more than 2^-4 of the second)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.ops.sparse import BatchedCSR

    recs = []
    rows = SPARSE_FIT_ROWS
    _, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM, SPMV_NNZ,
                                               seed=4)
    idx = indices.reshape(rows, SPMV_NNZ)
    v16 = values.reshape(rows, SPMV_NNZ).astype(np.float16)
    coef = np.random.default_rng(5).normal(size=SPMV_DIM).astype(np.float16)
    resid = np.random.default_rng(6).normal(size=rows).astype(np.float16)
    batch = BatchedCSR(idx, v16, SPMV_DIM)
    t0 = time.perf_counter()
    margins = batch.matvec(torch.from_numpy(coef).cuda())
    grad = batch.rmatvec(torch.from_numpy(resid).cuda())
    torch.cuda.synchronize()
    sparse_s = time.perf_counter() - t0
    prods = v16.astype(np.float32) * coef.astype(np.float32)[idx]
    want = prods.sum(1, dtype=np.float64)
    terms = np.abs(prods).sum(1, dtype=np.float64)
    got = margins.cpu().double().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -14)))
                  - 10)
    if margins.dtype != torch.float16 or not np.all(
            np.abs(got - want) <= ulp + 2.0 ** -11 * terms):
        fail("half Z3: float16 sparse margins beyond their bound")
    contrib = torch.from_numpy(v16) * torch.from_numpy(resid)[:, None]
    bf16_sum_check(torch, "half Z3 rmatvec", grad.cpu(), contrib.reshape(-1),
                   torch.from_numpy(idx.reshape(-1)), SPMV_DIM,
                   unit=2.0 ** -11)
    recs.append({"path": "half_Z3", "case": "batched_csr", "rows": rows,
                 "nnz": SPMV_NNZ, "dim": SPMV_DIM, "matvec_rmatvec_s":
                 sparse_s, "margins_max_abs_err": float(
                     np.abs(got - want).max())})
    del batch, margins, grad, contrib, prods

    x, y = mnist_like(KNN_TRAIN, seed=61)
    q, qy = mnist_like(Z3_KNN_QUERIES, seed=62)
    x16 = (x / 255.0).astype(np.float16)
    q16 = (q / 255.0).astype(np.float16)
    model = fml.Knn().set_k(KNN_K).fit(fml.Table({"features": x16,
                                                  "label": y}))
    queries = fml.Table({"features": q16})

    def knn():
        (out,) = model.transform(queries)
        return out.column("prediction")

    first_s, call_s, pred = timed_calls(torch, knn, calls=2)
    # The first KNN_CHECK queries against float32 numpy.
    pred = pred[:KNN_CHECK]
    xd, qd = x16.astype(np.float32), q16[:KNN_CHECK].astype(np.float32)
    d2 = ((qd * qd).sum(1)[:, None] - 2.0 * qd @ xd.T
          + (xd * xd).sum(1)[None])
    part = np.partition(d2, KNN_K, axis=1)[:, :KNN_K + 1]
    part.sort(axis=1)
    nn = np.argpartition(d2, KNN_K - 1, axis=1)[:, :KNN_K]
    want = np.array([np.bincount(y[r].astype(np.int64),
                                 minlength=KNN_CLASSES).argmax() for r in nn])
    decisive = (part[:, KNN_K] - part[:, KNN_K - 1]) > 2.0 ** -4
    agree = float(np.mean(pred == want))
    if agree < 0.99 or not np.array_equal(pred[decisive], want[decisive]):
        fail(f"half Z3 knn: {agree} of predictions agree with float32 numpy")
    recs.append({"path": "half_Z3", "case": "knn", "train": KNN_TRAIN,
                 "queries": Z3_KNN_QUERIES, "d": MNIST_D, "k": KNN_K,
                 "first_call_s": first_s, "call_s": call_s,
                 "queries_per_s": Z3_KNN_QUERIES / call_s,
                 "agreement": agree,
                 "queries_inside_margin": int((~decisive).sum())})
    del d2

    n, d, k = Z3_KMEANS
    rng = np.random.default_rng(63)
    centers = rng.normal(size=(k, d)) * 3.0
    xk = (centers[rng.integers(0, k, size=n)]
          + rng.normal(size=(n, d))).astype(np.float16)
    # StandardScaler -> KMeans (a run of two stages: the fused executor),
    # the statistics of the float32 rows, the centroids the scaled centers.
    scaler = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s")
              .fit(fml.Table({"features": xk.astype(np.float32)})))
    st = scaler._arrays()
    km = fml.PipelineModel([scaler, fml.KMeansModel().set_features_col("s")
                            .set_model_data(fml.Table({"centroids": (
                                (centers - st["mean"]) / st["std"])[None]}))])
    table = fml.Table({"features": xk})

    def kmeans():
        (out,) = km.transform(table)
        return out.column("prediction")

    first_s, call_s, pred = timed_calls(torch, kmeans, calls=5)
    xf = ((xk.astype(np.float32) - st["mean"].astype(np.float32))
          / st["std"].astype(np.float32))
    cf = ((centers - st["mean"]) / st["std"]).astype(np.float16).astype(
        np.float32)
    d2 = ((xf * xf).sum(1)[:, None] - 2.0 * xf @ cf.T
          + (cf * cf).sum(1)[None])
    part = np.sort(d2, axis=1)[:, :2]
    decisive = (part[:, 1] - part[:, 0]) > 2.0 ** -4 * np.abs(part[:, 1])
    inside = z_decisions("half Z3 kmeans", pred, np.argmin(d2, axis=1),
                         decisive)
    recs.append({"path": "half_Z3", "case": "scaler_kmeans_transform",
                 "rows": n, "d": d, "k": k, "first_call_s": first_s,
                 "call_s": call_s, "rows_per_s": n / call_s,
                 "rows_inside_margin": inside})
    for rec in recs:
        rec["card"] = card_line()
        log("path " + json.dumps(rec))
    return recs


def z_examples(torch):
    """The examples on the card: each of :data:`Z_EXAMPLES` run as a
    subprocess with its default size and device (``cuda``); it must exit 0
    and print its OK token. Returns ``{script: seconds}``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    done = {}
    for script in Z_EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable,
                               os.path.join(here, "examples", script)],
                              capture_output=True, text=True, env=env,
                              timeout=Z_EXAMPLE_TIMEOUT_S, cwd=here)
        secs = time.perf_counter() - t0
        last = proc.stdout.strip().splitlines()[-3:]
        if proc.returncode != 0 or not any(line.endswith("OK")
                                           for line in last):
            fail(f"example {script}: rc={proc.returncode}\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        done[script] = secs
        log("path " + json.dumps({"path": "half_Z_example", "script": script,
                                  "seconds": secs, "last_lines": last}))
    return done


def half_path(torch, timer):
    """Path Z: Z0's ``spmv``, ``segment_sum`` and ``topk`` cases; then the
    main path with the counts at 0 — Z1 (serving under ``half_inference``),
    Z2 (the plan fit under ``half``), Z3 (float16 columns) — the counts
    read; then Z0's ``fused_chain`` at its three shapes (the five-stage
    chain at 65,536 x 64, MNIST-width multinomial at 10,000 x 784, k = 10,
    StandardScaler -> KMeans at 262,144 x 128, k = 64) against the plain
    chain under ``half_inference``; then the examples. Returns ``(launches
    by kernel, {kernel name: [f16 records]})``; fails when a kernel of the
    path never launched."""
    import flinkml_tpu_torch as fml

    recs = half_kernel_phase(torch, timer)
    fml.reset_launch_counts()
    _, models = z1_serving(torch)
    z2_plan_fit(torch)
    z3_columns(torch)
    counts = fml.launch_counts()
    for name in ("fused_chain", "spmv", "segment_sum", "topk"):
        if counts[name] < 1:
            fail(f"path Z: {name} never launched ({counts})")
    recs["fused_chain"] = []
    pol = z_policy(Z_HALF_INFERENCE)
    for case in ("five_stage", "mnist", "kmeans"):
        model, table, rows = models[case]
        kernels = [s.transform_kernel() for s in model.stages]
        rec = {"case": case, "policy": "half_inference", "rows": rows}
        rec.update(tier_kernel_case(torch, timer, f"half {case}", kernels,
                                    table, rows, pol))
        rec["card"] = card_line()
        log("kernel_f16 fused_chain " + json.dumps(rec))
        recs["fused_chain"].append(rec)
    del models
    z_examples(torch)
    return counts, recs


# -- paths E, F, G: streamed, out-of-core and checkpointed linear fits --------------

#: Path E: the Criteo profile streamed out of core, 8 batches of 65,536
#: rows (16 until path N joined the run), half of the CSR bytes over the
#: cache's memory budget; 2 epochs (5 until path L joined the run, 3
#: until path U), stopped at 1 and resumed.
STREAM_BATCHES, STREAM_ROWS, STREAM_EPOCHS = 8, 65_536, 2  # 3 until path U
STREAM_STOP, STREAM_INTERVAL = 1, 1
STREAM_LR, STREAM_REG = 0.5, 1e-4
#: Path F: BASELINE config #3 at ``bench.py:_inner_svc``'s workload, 10
#: epochs (20 until path N joined the run).
SVC_ROWS, SVC_D, SVC_BATCH, SVC_EPOCHS = 1_000_000, 123, 262_144, 5  # 10 until U
SVC_REG, SVC_EN, SVC_LR = 2e-4, 0.5, 0.1
SVC_SPARSE_ROWS, SVC_SERVE_SPARSE, SVC_SERVE_DENSE = 262_144, 65_536, 100_000
SVC_STREAM_BATCHES = 16
#: Path G: BASELINE config #4 at ``bench.py:_inner_ftrl``'s workload.
FTRL_BATCHES, FTRL_ROWS, FTRL_D = 64, 16_384, 123
FTRL_ALPHA, FTRL_BETA, FTRL_REG, FTRL_EN = 0.1, 1.0, 0.002, 0.5
FTRL_INTERVAL, FTRL_CRASH = 16, 32


def numpy_margin(loss, dot, y, w):
    """The margin terms of ``ops/losses.py`` in float64 numpy:
    ``(d loss/d margin, per-example loss)``."""
    if loss == "squared":
        resid = dot - y
        return w * resid, 0.5 * w * resid * resid
    ys = 2.0 * y - 1.0
    margin = dot * ys
    if loss == "hinge":
        return w * (-ys * (margin < 1.0)), w * np.maximum(1.0 - margin, 0.0)
    return w * (-ys / (1.0 + np.exp(margin))), w * np.logaddexp(0.0, -margin)


def numpy_prox(coef, grad, wsum, lr, l2, l1):
    """The proximal SGD update of ``_linear_sgd._prox_step`` in float64."""
    grad = grad + 2.0 * l2 * coef
    step = lr / wsum
    new = coef - step * grad
    return np.sign(new) * np.maximum(np.abs(new) - step * l1, 0.0)


def numpy_csr_stream_fit(batches, dim, epochs, lr, l2, l1, loss="logistic"):
    """Float64 numpy run of the streamed sparse trainer: one step per CSR
    batch ``(indptr, indices, values, y, w)``, in batch order, every
    epoch (the padding cells add exact zeros, so they are left out)."""
    coef = np.zeros(dim)
    for _ in range(epochs):
        for indptr, idx, val, y, w in batches:
            n = indptr.size - 1
            rows = np.repeat(np.arange(n), np.diff(indptr))
            v = val.astype(np.float64)
            dot = np.bincount(rows, weights=v * coef[idx], minlength=n)
            mult, _ = numpy_margin(loss, dot, y.astype(np.float64),
                                   w.astype(np.float64))
            grad = np.bincount(idx, weights=v * mult[rows], minlength=dim)
            coef = numpy_prox(coef, grad, float(w.sum()), lr, l2, l1)
    return coef


def numpy_dense_windows_fit(x, y, w, seed, batch, epochs, lr, l2, l1, loss):
    """Float64 numpy run of the in-RAM dense trainer under any margin loss
    and elastic net: the seeded shuffle, the rotating windows."""
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    x64, y64, w64 = (a[perm].astype(np.float64) for a in (x, y, w))
    n_windows = max(-(-n // batch), 1)
    coef = np.zeros(x.shape[1])
    for ep in range(epochs):
        start = min((ep % n_windows) * batch, n - batch)
        xb, yb, wb = (a[start:start + batch] for a in (x64, y64, w64))
        mult, _ = numpy_margin(loss, xb @ coef, yb, wb)
        coef = numpy_prox(coef, xb.T @ mult, wb.sum(), lr, l2, l1)
    return coef


def numpy_dense_stream_fit(batches, epochs, lr, l2, l1, loss):
    """Float64 numpy run of the streamed dense trainer over ``(x, y)``
    batches, unit weights."""
    coef = np.zeros(batches[0][0].shape[1])
    for _ in range(epochs):
        for x, y in batches:
            x64 = x.astype(np.float64)
            w = np.ones(x.shape[0])
            mult, _ = numpy_margin(loss, x64 @ coef, y.astype(np.float64), w)
            coef = numpy_prox(coef, x64.T @ mult, w.sum(), lr, l2, l1)
    return coef


def numpy_ftrl(batches, alpha, beta, l1, l2):
    """Float64 numpy FTRL-proximal over ``(x, y)`` batches (unit weights),
    the algebra of ``online_logistic_regression._ftrl_algebra``."""
    dim = batches[0][0].shape[1]
    z, nacc, coef = np.zeros(dim), np.zeros(dim), np.zeros(dim)
    for x, y in batches:
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        p = 1.0 / (1.0 + np.exp(-(x64 @ coef)))
        g = x64.T @ (p - y64) / x.shape[0]
        sigma = (np.sqrt(nacc + g * g) - np.sqrt(nacc)) / alpha
        z = z + g - sigma * coef
        nacc = nacc + g * g
        coef = np.where(np.abs(z) <= l1, 0.0,
                        -(z - np.sign(z) * l1)
                        / ((beta + np.sqrt(nacc)) / alpha + l2))
    return coef


def rel_err(got, want) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


class FeedWaits:
    """Records each :class:`PrefetchingDeviceFeed`'s consumer wait (one
    feed per epoch of a streamed fit) and its host-clock span from
    construction to close while installed in the module the trainer takes
    it from."""

    def __init__(self):
        from flinkml_tpu_torch.iteration import datacache

        self.module, self.original = datacache, None
        self.waits, self.spans = [], []

    def __enter__(self):
        original, waits = self.module.PrefetchingDeviceFeed, self.waits
        spans = self.spans

        class Recorded(original):
            def __init__(self, *args, **kwargs):
                self._t0 = time.perf_counter()
                super().__init__(*args, **kwargs)

            def close(self):
                if not getattr(self, "_recorded", False):
                    self._recorded = True
                    waits.append(self.wait_s)
                    spans.append(time.perf_counter() - self._t0)
                super().close()

        self.original = original
        self.module.PrefetchingDeviceFeed = Recorded
        return self

    def __exit__(self, *exc):
        self.module.PrefetchingDeviceFeed = self.original
        return False


def csr_batch_dicts(indptr, indices, values, y, n_batches, rows, dim):
    """The flat CSR batch dicts of the streamed sparse fit (each component
    one 2-D row), and the same batches as host CSR tuples."""
    dicts, tuples = [], []
    for b in range(n_batches):
        lo, hi = b * rows, (b + 1) * rows
        ip = indptr[lo:hi + 1] - indptr[lo]
        idx = indices[indptr[lo]:indptr[hi]]
        val = values[indptr[lo]:indptr[hi]]
        yb = y[lo:hi]
        w = np.ones(rows, np.float32)
        dicts.append({"indptr": ip[None], "indices": idx[None],
                      "values": val[None], "y": yb[None], "w": w[None],
                      "dim": np.array([[dim]], np.int64)})
        tuples.append((ip, idx, val, yb, w))
    return dicts, tuples


def stream_path(torch, timer):
    """Path E: LogisticRegression streamed out of core over the Criteo
    profile (dim 1e6, 39 nnz a row, float32): 16 batches of 65,536 rows
    (1,048,576) in a DataCache whose memory budget is half the CSR bytes
    (8 batches spill to a temporary directory), ``STREAM_EPOCHS`` epochs
    with a checkpoint every ``STREAM_INTERVAL``; then a fit stopped at
    epoch ``STREAM_STOP`` and resumed to the end,
    and the same fit from an in-RAM cache. Each against a float64 numpy
    run of the same steps in batch order within 1e-5 of the largest
    coefficient, and against each other within 1e-5 (the unsorted
    ``segment_sum`` adds in a run-dependent order). Reports samples/s,
    the device's busy share, the feed's wait per epoch, the ``spmv`` and
    ``segment_sum`` time per batch beside their bounds, and the
    ``segment_sum`` time on the stream's padded cells (a quarter of them on
    segment 0) beside the same count of unpadded cells; on those inputs
    each kernel is held against its plain version (rtol/atol 1e-5).
    Returns the launch counts of the main fit."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    n, dim, nnz = STREAM_BATCHES * STREAM_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=7)
    dicts, tuples = csr_batch_dicts(indptr, indices, values, y,
                                    STREAM_BATCHES, STREAM_ROWS, dim)
    batch_bytes = sum(a.nbytes for a in dicts[0].values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        def cache(spill):
            w = DataCacheWriter(os.path.join(tmp, spill) if spill else None,
                                batch_bytes * STREAM_BATCHES // 2
                                if spill else None)
            for b in dicts:
                w.append(b)
            return w.finish()

        spilled = cache("spill")
        if len(spilled.segments) != STREAM_BATCHES // 2:
            fail(f"stream: {len(spilled.segments)} batches spilled, expected "
                 f"{STREAM_BATCHES // 2}")

        def est(epochs, manager=None, resume=False):
            return (fml.LogisticRegression(
                checkpoint_manager=manager,
                checkpoint_interval=STREAM_INTERVAL if manager else 0,
                resume=resume).set_max_iter(epochs).set_tol(0.0)
                .set_learning_rate(STREAM_LR).set_reg(STREAM_REG))

        est(1).fit(cache(None))   # first fit: allocator and kernels warm
        torch.cuda.synchronize()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=10)
        fml.reset_launch_counts()
        with FeedWaits() as feed:
            t0 = time.perf_counter()
            main = est(STREAM_EPOCHS, mgr).fit(spilled).coefficient
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        counts = fml.launch_counts()
        steps = STREAM_BATCHES * STREAM_EPOCHS
        if counts["spmv"] != steps or counts["segment_sum"] != steps:
            fail(f"stream: launches {counts} in {steps} steps")
        if mgr.all_epochs() != sorted(
                set(range(STREAM_INTERVAL, STREAM_EPOCHS + 1,
                          STREAM_INTERVAL)) | {STREAM_EPOCHS}):
            fail(f"stream: checkpoints at {mgr.all_epochs()}")

        ref = numpy_csr_stream_fit(tuples, dim, STREAM_EPOCHS, STREAM_LR,
                                   STREAM_REG, 0.0)
        errs = {"numpy": rel_err(main, ref)}
        stop_mgr = CheckpointManager(os.path.join(tmp, "stop"))
        est(STREAM_STOP, stop_mgr).fit(spilled)
        resumed = est(STREAM_EPOCHS, stop_mgr, resume=True).fit(
            spilled).coefficient
        errs["resumed"] = rel_err(resumed, np.asarray(main, np.float64))
        in_ram = est(STREAM_EPOCHS).fit(cache(None)).coefficient
        errs["in_ram"] = rel_err(in_ram, np.asarray(main, np.float64))
        for what, err in errs.items():
            if not np.isfinite(err) or err > 1e-5:
                fail(f"stream: {what} differs by {err} of the largest "
                     "coefficient (limit 1e-5)")
        share = device_share(torch, lambda: est(1).fit(spilled))

        # The step's kernels at one batch's shape (width 64 over 39 nnz).
        bi, bv = sgd._pack_uniform_ell(*tuples[0][:3], np.float32)
        ib, vb = (torch.from_numpy(a).cuda() for a in (bi, bv))
        coef = torch.from_numpy(np.asarray(main, np.float32)).cuda()
        contrib = torch.randn(vb.numel(), device="cuda") * vb.reshape(-1)
        flat = ib.reshape(-1)
        # T2: the same cell count with no padding (random ids, as the
        # in-RAM bucketed fit's cells).
        dense_ids = torch.randint(0, dim, (flat.numel(),), device="cuda",
                                  dtype=torch.int32)
        # Each kernel against its plain version on these inputs, padding
        # cells included (rtol/atol 1e-5, as the kernel phase).
        got = {"spmv": kspmv.spmv(ib, vb, coef),
               "segment_sum": ksegsum.segment_sum(contrib, flat, dim),
               "segment_sum_unpadded": ksegsum.segment_sum(contrib,
                                                           dense_ids, dim)}
        torch.cuda.synchronize()
        want = {"spmv": kspmv.spmv_plain(ib, vb, coef),
                "segment_sum": ksegsum.segment_sum_plain(contrib, flat, dim),
                "segment_sum_unpadded": ksegsum.segment_sum_plain(
                    contrib, dense_ids, dim)}
        kernel_errs = {}
        for what in got:
            check_close(f"stream: {what} vs plain", got[what], want[what],
                        1e-5, 1e-5)
            kernel_errs[what] = max_err(got[what], want[what])
        del got, want
        spmv_ms = timer(lambda: kspmv.spmv(ib, vb, coef))
        segsum_ms = timer(lambda: ksegsum.segment_sum(contrib, flat, dim))
        unpadded_ms = timer(lambda: ksegsum.segment_sum(contrib, dense_ids,
                                                        dim))
        cells = flat.numel()
        touched = int(torch.unique(flat).numel())
        spmv_bound, spmv_by = bound_ms(
            cells * 8 + touched * 4 + bi.shape[0] * 4, 2.0 * cells, "float32")
        # Ids and values read once, the [dim] output written once.
        segsum_bound, segsum_by = bound_ms(cells * 8 + dim * 4, cells,
                                           "float32")
        pad_cells = int((vb == 0).sum())
        samples = n * STREAM_EPOCHS
        rec = {"path": "stream_sparse_lr", "rows": n, "dim": dim, "nnz": nnz,
               "batches": STREAM_BATCHES, "batch_rows": STREAM_ROWS,
               "epochs": STREAM_EPOCHS, "spilled_batches":
               len(spilled.segments), "ell_width": int(bi.shape[1]),
               "fit_s": fit_s, "samples_per_s": samples / fit_s,
               "device_share": share,
               "host_share": None if share is None else 1.0 - share,
               "feed_wait_s_per_epoch": feed.waits,
               "spmv_ms_per_batch": spmv_ms,
               "spmv_bound_ms": spmv_bound, "spmv_bound_by": spmv_by,
               "segment_sum_ms_per_batch": segsum_ms,
               "segment_sum_ms_same_cells_unpadded": unpadded_ms,
               "segment_sum_bound_ms": segsum_bound,
               "segment_sum_bound_by": segsum_by,
               "kernel_max_abs_err": kernel_errs,
               "padding_cells_per_batch": pad_cells,
               "cells_per_batch": cells,
               "checkpoints": mgr.all_epochs(), "rel_err": errs,
               "launches": counts}
        log("path " + json.dumps(rec))
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def svc_path(torch):
    """Path F, BASELINE config #3 at ``bench.py:_inner_svc``'s workload
    (1,000,000 x 123 float32, batch 262,144, reg 2e-4, elasticNet 0.5, 20
    epochs): LinearSVC and LinearRegression (SGD) fitted in RAM;
    LinearRegression ``solver="normal"``; a sparse LinearSVC over 262,144
    Criteo-profile rows (``spmv`` + ``segment_sum``); a streamed dense
    LinearRegression over 16 batches of the same data; LinearSVCModel
    serving 65,536 Criteo rows (``spmv``) and 100,000 dense rows. Each
    held against float64 numpy: the SGD fits within 1e-4 of the largest
    coefficient (float32 products over 262,144 rows, 20 steps), the
    normal solve within 1e-3 (a float32 gram over 1e6 rows), the margins
    within 1e-4. Returns the launch counts of the sparse fit and the
    serving."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    x, y, w = make_data(SVC_ROWS, SVC_D, seed=3)
    true = np.random.default_rng(4).normal(size=SVC_D)
    y_reg = (x.astype(np.float64) @ true).astype(np.float32)
    l1, l2 = SVC_REG * SVC_EN, SVC_REG * (1.0 - SVC_EN)
    recs, errs = {}, {}

    def sgd_est(cls):
        return (cls().set_seed(0).set_tol(0.0).set_max_iter(SVC_EPOCHS)
                .set_global_batch_size(SVC_BATCH).set_learning_rate(SVC_LR)
                .set_reg(SVC_REG).set_elastic_net(SVC_EN))

    for name, cls, labels, loss in (
            ("svc", fml.LinearSVC, y, "hinge"),
            ("linreg_sgd", fml.LinearRegression, y_reg, "squared")):
        table = fml.Table({"features": x, "label": labels})
        first_s, fit_s, model = timed_calls(
            torch, lambda: sgd_est(cls).fit(table), calls=1)
        ref = numpy_dense_windows_fit(x, labels, w, 0, SVC_BATCH, SVC_EPOCHS,
                                      SVC_LR, l2, l1, loss)
        errs[name] = rel_err(model.coefficient, ref)
        recs[name] = {"first_fit_s": first_s, "fit_s": fit_s,
                      "samples_per_s": SVC_BATCH * SVC_EPOCHS / fit_s}
        if name == "svc":
            svc_model = model

    table = fml.Table({"features": x, "label": y_reg})
    _, normal_s, normal = timed_calls(torch, lambda: fml.LinearRegression()
                                      .set_solver("normal").set_reg(SVC_REG)
                                      .fit(table), calls=1)
    x64 = x.astype(np.float64)
    a = x64.T @ x64 + 2.0 * SVC_REG * np.eye(SVC_D)
    ref = np.linalg.solve(a, x64.T @ y_reg.astype(np.float64))
    errs["linreg_normal"] = rel_err(normal.coefficient, ref)
    recs["linreg_normal"] = {"fit_s": normal_s,
                             "rows_per_s": SVC_ROWS / normal_s}

    # Streamed dense LinearRegression over 16 batches of the same rows.
    bs = SVC_ROWS // SVC_STREAM_BATCHES
    parts = [(x[i * bs:(i + 1) * bs], y_reg[i * bs:(i + 1) * bs])
             for i in range(SVC_STREAM_BATCHES)]
    stream_epochs = 5
    _, stream_s, streamed = timed_calls(torch, lambda: (
        fml.LinearRegression().set_tol(0.0).set_max_iter(stream_epochs)
        .set_learning_rate(SVC_LR).set_reg(SVC_REG).set_elastic_net(SVC_EN)
        .fit(iter(fml.Table({"features": px, "label": py})
                  for px, py in parts))), calls=1)
    ref = numpy_dense_stream_fit(parts, stream_epochs, SVC_LR, l2, l1,
                                 "squared")
    errs["linreg_stream"] = rel_err(streamed.coefficient, ref)
    recs["linreg_stream"] = {
        "fit_s": stream_s, "batches": SVC_STREAM_BATCHES,
        "epochs": stream_epochs,
        "samples_per_s": SVC_ROWS * stream_epochs / stream_s}

    # The sparse LinearSVC in RAM (batch >= rows: full-batch steps).
    sn, dim, nnz = SVC_SPARSE_ROWS, SPMV_DIM, SPMV_NNZ
    _, indices, values, ys, _ = make_criteo_csr(sn, dim, nnz, seed=8)
    rows = criteo_rows(indices, values, sn, nnz, dim)
    stable = fml.Table({"features": rows, "label": ys})
    fml.reset_launch_counts()
    _, sparse_s, sparse_model = timed_calls(torch, lambda: (
        fml.LinearSVC().set_seed(0).set_tol(0.0).set_max_iter(SVC_EPOCHS)
        .set_global_batch_size(sn).set_learning_rate(SVC_LR)
        .set_reg(SVC_REG).set_elastic_net(SVC_EN).fit(stable)), calls=1)
    counts = dict(fml.launch_counts())
    if counts["spmv"] < SVC_EPOCHS or counts["segment_sum"] < SVC_EPOCHS:
        fail(f"svc: sparse fit launches {counts}")
    ip, ci, cv, _, cy, cw = labeled_sparse_data(stable, "features", "label")
    ref = numpy_csr_stream_fit([(ip, ci, cv, cy, cw)], dim, SVC_EPOCHS,
                               SVC_LR, l2, l1, loss="hinge")
    errs["svc_sparse"] = rel_err(sparse_model.coefficient, ref)
    recs["svc_sparse"] = {"fit_s": sparse_s,
                          "samples_per_s": sn * SVC_EPOCHS / sparse_s}

    # Serving: 65,536 Criteo rows (spmv) and 100,000 dense rows.
    serve_rows = rows[:SVC_SERVE_SPARSE]
    before = fml.launch_counts()["spmv"]
    _, sparse_serve_s, (out,) = timed_calls(torch, lambda: sparse_model
                                            .transform(fml.Table(
                                                {"features": serve_rows})))
    ip, ci, cv, _, _, _ = labeled_sparse_data(
        fml.Table({"features": serve_rows, "label": ys[:SVC_SERVE_SPARSE]}),
        "features", "label")
    r = np.repeat(np.arange(SVC_SERVE_SPARSE), np.diff(ip))
    want = np.bincount(r, weights=cv.astype(np.float64)
                       * sparse_model.coefficient.astype(np.float32)
                       .astype(np.float64)[ci], minlength=SVC_SERVE_SPARSE)
    errs["serve_sparse"] = rel_err(out.column("rawPrediction"), want)
    serve_launch = fml.launch_counts()["spmv"] - before
    counts["spmv"] += serve_launch
    xd = x[:SVC_SERVE_DENSE]
    _, dense_serve_s, (dout,) = timed_calls(
        torch, lambda: svc_model.transform(fml.Table({"features": xd})))
    want = xd.astype(np.float64) @ svc_model.coefficient
    errs["serve_dense"] = rel_err(dout.column("rawPrediction"), want)
    if not np.array_equal(dout.column("prediction"),
                          (dout.column("rawPrediction") >= 0) * 1.0):
        fail("svc: dense predictions disagree with their margins")
    limits = {"linreg_normal": 1e-3}
    for what, err in errs.items():
        if not np.isfinite(err) or err > limits.get(what, 1e-4):
            fail(f"svc: {what} differs from float64 numpy by {err} of the "
                 f"largest coefficient (limit {limits.get(what, 1e-4)})")
    recs["serve"] = {"sparse_rows_per_s": SVC_SERVE_SPARSE / sparse_serve_s,
                     "dense_rows_per_s": SVC_SERVE_DENSE / dense_serve_s,
                     "sparse_spmv_launches": serve_launch}
    log("path " + json.dumps({"path": "svc_linreg", "rows": SVC_ROWS,
                              "d": SVC_D, "batch": SVC_BATCH,
                              "epochs": SVC_EPOCHS, "reg": SVC_REG,
                              "elastic_net": SVC_EN, "fits": recs,
                              "rel_err": errs, "launches": counts}))
    return counts


def ftrl_path(torch):
    """Path G, BASELINE config #4 at ``bench.py:_inner_ftrl``'s workload:
    ``OnlineLogisticRegression.fit_stream`` over 64 batches of 16,384 x 123
    float32 rows (alpha 0.1, beta 1.0, reg 0.002, elasticNet 0.5), with a
    checkpoint every 16 batches; a run that crashes at batch 32 and
    resumes from its snapshot equals the uninterrupted one bit for bit
    (cuBLAS products, no atomics); against a float64 numpy FTRL within
    1e-4 of the largest coefficient (float32 over 64 steps)."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager

    rng = np.random.default_rng(12)
    true = rng.normal(size=FTRL_D)
    parts = []
    for _ in range(FTRL_BATCHES):
        xb = rng.normal(size=(FTRL_ROWS, FTRL_D)).astype(np.float32)
        parts.append((xb, (xb @ true > 0).astype(np.float32)))
    tables = [fml.Table({"features": px, "label": py}) for px, py in parts]

    def est():
        return (fml.OnlineLogisticRegression().set_alpha(FTRL_ALPHA)
                .set_beta(FTRL_BETA).set_reg(FTRL_REG)
                .set_elastic_net(FTRL_EN))

    def crashing():
        for i, t in enumerate(tables):
            if i == FTRL_CRASH:
                raise RuntimeError("injected crash")
            yield t

    est().fit_stream(tables[:2])   # first fit: cuBLAS and allocator warm
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ftrl_")
    try:
        mgr = CheckpointManager(os.path.join(tmp, "main"), max_to_keep=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est().fit_stream(tables, checkpoint_manager=mgr,
                                 checkpoint_interval=FTRL_INTERVAL)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        plain_t0 = time.perf_counter()
        est().fit_stream(tables)
        torch.cuda.synchronize()
        no_ckpt_s = time.perf_counter() - plain_t0
        crash = CheckpointManager(os.path.join(tmp, "crash"), max_to_keep=10)
        try:
            est().fit_stream(crashing(), checkpoint_manager=crash,
                             checkpoint_interval=FTRL_INTERVAL)
            fail("ftrl: the injected crash did not happen")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        if crash.latest_epoch() != FTRL_CRASH:
            fail(f"ftrl: the crashed run's newest snapshot is "
                 f"{crash.latest_epoch()}")
        resumed = est().fit_stream(tables, checkpoint_manager=crash,
                                   checkpoint_interval=FTRL_INTERVAL,
                                   resume=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if model.model_version != FTRL_BATCHES or \
            resumed.model_version != FTRL_BATCHES:
        fail(f"ftrl: versions {model.model_version}, {resumed.model_version}")
    resume_exact = bool(np.array_equal(resumed.coefficient, model.coefficient))
    if not resume_exact:
        fail("ftrl: the resumed run differs from the uninterrupted one by "
             f"{rel_err(resumed.coefficient, model.coefficient)}")
    err = rel_err(model.coefficient, numpy_ftrl(
        parts, FTRL_ALPHA, FTRL_BETA, FTRL_REG * FTRL_EN,
        FTRL_REG * (1.0 - FTRL_EN)))
    if not np.isfinite(err) or err > 1e-4:
        fail(f"ftrl: coefficient differs from float64 numpy by {err} of the "
             "largest (limit 1e-4)")
    log("path " + json.dumps({
        "path": "ftrl", "batches": FTRL_BATCHES, "batch_rows": FTRL_ROWS,
        "d": FTRL_D, "fit_s": fit_s, "batches_per_s": FTRL_BATCHES / fit_s,
        "samples_per_s": FTRL_BATCHES * FTRL_ROWS / fit_s,
        "fit_without_checkpoints_s": no_ckpt_s,
        "checkpoints": [16, 32, 48, 64], "resume_bit_exact": resume_exact,
        "rel_err": err}))


# -- path H: the input pipeline (data/) and the sorted-column stream ---------------

#: H1: BASELINE config #1's width (a9a: 123 binary features, 14 set a row)
#: through a LibSVM file, 16 batches of 16,384 rows, 5 epochs (20 until
#: path N joined the run, 10 until path U).
A9A_ROWS, A9A_D, A9A_NNZ, A9A_BATCH, A9A_EPOCHS = 262_144, 123, 14, 16_384, 5
A9A_SHUFFLE, A9A_LR = 8, 0.1
#: H2: path E's Criteo profile (dim 1e6, 39 draws a row), 8 batches of
#: 65,536 rows through a prefetched Dataset, path E's step sizes; 2 epochs
#: (5, path E's, until path K joined the run, 3 until path L did: H2 runs
#: its fit twice, the second under the profiler; 16 batches until path L's
#: references ran after its ranks, 8 until path N joined).
SORTED_BATCHES, SORTED_ROWS, SORTED_EPOCHS = 4, 65_536, 2
#: H3: BASELINE config #4's width (path G) through an ElasticFeed.
ELASTIC_WORLD, ELASTIC_RESUME_WORLD, ELASTIC_SHUFFLE = 4, 2, 4


def shuffled_order(n, buffer, seed):
    """The batch order that ``ShuffleOp(buffer, seed)`` gives ``n``
    batches, drawn here from its own numpy Generator: fill the buffer,
    then for every arriving batch emit a uniformly drawn resident one and
    take its slot, and drain in random order at the end."""
    rng = np.random.default_rng(seed)
    buf, out = [], []
    for b in range(n):
        if len(buf) < buffer:
            buf.append(b)
            continue
        j = int(rng.integers(0, len(buf)))
        out.append(buf[j])
        buf[j] = b
    while buf:
        out.append(buf.pop(int(rng.integers(0, len(buf)))))
    return out


def write_a9a_libsvm(path, n, d, nnz, seed):
    """``n`` a9a-shaped rows (``nnz`` of ``d`` binary features set, labels
    +-1 from a planted model) written as LibSVM; returns the dense rows
    and the labels mapped to {0, 1}."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.random((n, d)).argpartition(nnz, axis=1)[:, :nnz],
                   axis=1)
    x = np.zeros((n, d), dtype=np.float32)
    np.put_along_axis(x, cols, 1.0, axis=1)
    planted = rng.normal(size=d)
    y = (x @ planted + rng.normal(scale=0.5, size=n) > planted.sum() * nnz
         / d).astype(np.float32)
    tokens = [f"{j + 1}:1" for j in range(d)]
    with open(path, "w") as f:
        for r in range(n):
            f.write(("+1 " if y[r] else "-1 ")
                    + " ".join(tokens[j] for j in cols[r]) + "\n")
    return x, y


def labels_to_binary(t):
    """a9a's labels are +-1; the binomial fit takes {0, 1}."""
    return t.with_column("label",
                         (np.asarray(t.column("label")) > 0).astype(np.float64))


def ingest_path(torch):
    """Path H1: ``Dataset.from_libsvm`` of 262,144 a9a-shaped rows (a
    LibSVM file written here), batch 16,384, ``.map`` of the +-1 labels to
    {0, 1}, ``.shuffle(8, seed=0)``, ``.prefetch(2)``, feeding
    ``LogisticRegression().fit`` (``A9A_EPOCHS``, tol 0). The native parser
    must be the one used; the parsed rows equal the generator's; the
    coefficient is held against a float64 numpy run of the same batches in
    the same shuffled order (1e-4 of the largest coefficient). Reports the
    parse's rows/s (after a first parse that builds the parser), the bare
    pipeline's rows/s and stall fraction, the fit's prefetch gauges and
    samples/s."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.data import Dataset
    from flinkml_tpu_torch.io import _native, read_libsvm
    from flinkml_tpu_torch.utils.metrics import default_registry

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        path = os.path.join(tmp, "a9a_like.libsvm")
        t0 = time.perf_counter()
        x, y = write_a9a_libsvm(path, A9A_ROWS, A9A_D, A9A_NNZ, seed=21)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        before = dict(_native.PARSES)
        t0 = time.perf_counter()
        read_libsvm(path, n_features=A9A_D)   # builds the parser (g++) first
        first_parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels, indptr, _, _, _ = read_libsvm(path, n_features=A9A_D)
        parse_s = time.perf_counter() - t0
        if _native.PARSES[("libsvm", "native")] != \
                before.get(("libsvm", "native"), 0) + 2:
            fail("ingest: the native LibSVM parser was not used")
        if labels.size != A9A_ROWS or int(indptr[-1]) != A9A_ROWS * A9A_NNZ:
            fail(f"ingest: parsed {labels.size} rows, {int(indptr[-1])} nnz")

        def dataset():
            return Dataset.from_libsvm(path, batch_size=A9A_BATCH,
                                       n_features=A9A_D)

        parsed = list(dataset().map(labels_to_binary))
        got_x = np.concatenate([t.column("features") for t in parsed])
        got_y = np.concatenate([t.column("label") for t in parsed])
        if not (np.array_equal(got_x, x) and np.array_equal(got_y, y)):
            fail("ingest: the parsed rows differ from the generator's")

        def pipeline(group):
            return (dataset().map(labels_to_binary)
                    .shuffle(A9A_SHUFFLE, seed=0)
                    .prefetch(2, metrics_group=group))

        it = pipeline("data.prefetch.h1_bare").iterate()
        t0 = time.perf_counter()
        rows = sum(t.num_rows for t in it)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        bare_stall = it._prefetcher.stall_fraction
        if rows != A9A_ROWS:
            fail(f"ingest: the pipeline delivered {rows} rows")

        def est():
            return (fml.LogisticRegression().set_max_iter(A9A_EPOCHS)
                    .set_tol(0.0).set_learning_rate(A9A_LR))

        est().set_max_iter(1).fit(pipeline(None))   # cuBLAS and allocator warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coef = est().fit(pipeline("data.prefetch.h1_fit")).coefficient
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        gauges = default_registry().snapshot()["data.prefetch.h1_fit"][
            "gauges"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    order = shuffled_order(A9A_ROWS // A9A_BATCH, A9A_SHUFFLE, 0)
    batches = [(x[b * A9A_BATCH:(b + 1) * A9A_BATCH],
                y[b * A9A_BATCH:(b + 1) * A9A_BATCH]) for b in order]
    err = rel_err(coef, numpy_dense_stream_fit(batches, A9A_EPOCHS, A9A_LR,
                                               0.0, 0.0, "logistic"))
    if not np.isfinite(err) or err > 1e-4:
        fail(f"ingest: coefficient differs from float64 numpy by {err} of "
             "the largest (limit 1e-4)")
    log("path " + json.dumps({
        "path": "ingest_H1", "rows": A9A_ROWS, "d": A9A_D, "nnz": A9A_NNZ,
        "batch_rows": A9A_BATCH, "epochs": A9A_EPOCHS,
        "file_bytes": file_bytes, "write_s": write_s,
        "build_and_parse_s": first_parse_s, "parse_s": parse_s,
        "parse_rows_per_s": A9A_ROWS / parse_s, "parser": "native",
        "pipeline_s": bare_s, "pipeline_rows_per_s": A9A_ROWS / bare_s,
        "pipeline_stall_fraction": bare_stall,
        "fit_s": fit_s, "samples_per_s": A9A_ROWS * A9A_EPOCHS / fit_s,
        "fit_epoch0_prefetch_rows_per_s": gauges.get("rows_per_sec"),
        "fit_epoch0_prefetch_stall_fraction": gauges.get("stall_fraction"),
        "shuffled_order": order, "rel_err": err}))


def criteo_merged_csr(n, dim, nnz, seed):
    """A ``make_criteo_csr`` draw with each row's repeated columns merged
    by sum (the rows ``SparseVector`` holds): ``(indptr, indices int64,
    values float64, y)``."""
    _, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=seed)
    idx2 = indices.reshape(n, nnz)
    order = np.argsort(idx2, axis=1, kind="stable")
    si = np.take_along_axis(idx2, order, axis=1)
    sv = np.take_along_axis(values.reshape(n, nnz).astype(np.float64),
                            order, axis=1)
    first = np.ones((n, nnz), dtype=bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    starts = np.flatnonzero(first.reshape(-1))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(first.sum(axis=1), out=indptr[1:])
    return (indptr, si.reshape(-1)[starts].astype(np.int64),
            np.add.reduceat(sv.reshape(-1), starts), y)


class EpochClock:
    """An ``IterationListener`` that records the host clock at the end of
    each epoch (its coefficient arrives on the host, so the card is done)."""

    def __init__(self):
        self.t0, self.ends = time.perf_counter(), []

    def on_epoch_watermark_incremented(self, epoch, state):
        self.ends.append(time.perf_counter())

    def on_iteration_terminated(self, state):
        pass


def sorted_stream_path(torch, timer):
    """Path H2: ``LogisticRegression(maxIter=5, tol=0).fit`` of a prefetched
    ``Dataset`` at the Criteo profile (path E's: dim 1e6, 39 draws a row;
    ``SORTED_BATCHES`` batches of 65,536 rows): a ``map`` builds each batch's
    ``SparseVector`` column from the CSR, ``.prefetch(2)`` packs it into a
    ``SortedSparseColumn`` (ELL width 64, pack-time sort tables) on its
    worker, and the fit takes the sorted stream (``spmv`` forward, sorted
    ``segment_sum`` gradient). Holds the coefficient against a float64
    numpy run of the same steps and against path E's CSR stream on the
    same batches (1e-5 of the largest coefficient each), and the step's
    two kernels against their plain versions on the first batch's own
    block (the sorted ``segment_sum`` bit for bit with the in-order sum).
    Reports samples/s for epoch 0 and for epochs 1-4, the device's busy
    share, and the sorted ``segment_sum``'s time on the block beside the
    same cells without their padding run. Returns the fit's launch counts."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.data import Dataset
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.table import SortedSparseColumn

    n, dim, nnz = SORTED_BATCHES * SORTED_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, y = criteo_merged_csr(n, dim, nnz, seed=7)

    def build_rows(t):
        lo = int(t.column("row")[0])
        vecs = np.empty(t.num_rows, dtype=object)
        for r in range(t.num_rows):
            a, b = indptr[lo + r], indptr[lo + r + 1]
            vecs[r] = fml.SparseVector._from_sorted(dim, indices[a:b],
                                                    values[a:b])
        return fml.Table({"features": vecs, "label": t.column("label")})

    ds = Dataset.from_arrays(
        fml.Table({"row": np.arange(n, dtype=np.int64), "label": y}),
        SORTED_ROWS).map(build_rows)

    def est(epochs):
        return (fml.LogisticRegression().set_max_iter(epochs).set_tol(0.0)
                .set_learning_rate(STREAM_LR).set_reg(STREAM_REG))

    original = sgd.train_linear_model_sorted_stream
    clock = EpochClock()
    routed = []

    def timed(*args, **kwargs):
        routed.append(True)
        clock.t0 = time.perf_counter()
        return original(*args, listeners=[clock], **kwargs)

    sgd.train_linear_model_sorted_stream = timed
    try:
        torch.cuda.synchronize()
        fml.reset_launch_counts()
        t0 = time.perf_counter()
        coef = est(SORTED_EPOCHS).fit(ds.prefetch(2)).coefficient
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = fml.launch_counts()
    finally:
        sgd.train_linear_model_sorted_stream = original
    steps = SORTED_BATCHES * SORTED_EPOCHS
    if not routed or counts["spmv"] != steps or \
            counts["segment_sum"] != steps:
        fail(f"sorted stream: routed {bool(routed)}, launches {counts} in "
             f"{steps} steps")
    epoch_s = np.diff([clock.t0] + clock.ends).tolist()

    tuples, dicts = [], []
    for b in range(SORTED_BATCHES):
        lo, hi = b * SORTED_ROWS, (b + 1) * SORTED_ROWS
        ip = indptr[lo:hi + 1] - indptr[lo]
        idx = indices[indptr[lo]:indptr[hi]].astype(np.int32)
        val = values[indptr[lo]:indptr[hi]].astype(np.float32)
        w = np.ones(SORTED_ROWS, np.float32)
        tuples.append((ip, idx, val, y[lo:hi], w))
        dicts.append({"indptr": ip[None], "indices": idx[None],
                      "values": val[None], "y": y[lo:hi][None],
                      "w": w[None], "dim": np.array([[dim]], np.int64)})
    errs = {"numpy": rel_err(coef, numpy_csr_stream_fit(
        tuples, dim, SORTED_EPOCHS, STREAM_LR, STREAM_REG, 0.0))}
    csr = sgd.train_linear_model_stream(
        iter(dicts), loss="logistic", max_iter=SORTED_EPOCHS,
        learning_rate=STREAM_LR, reg=STREAM_REG, elastic_net=0.0, tol=0.0,
        sparse_dim=dim)
    errs["csr_stream"] = rel_err(coef, np.asarray(csr, np.float64))
    for what, err in errs.items():
        if not np.isfinite(err) or err > 1e-5:
            fail(f"sorted stream: differs from {what} by {err} of the "
                 "largest coefficient (limit 1e-5)")
    share = device_share(torch, lambda: est(SORTED_EPOCHS).fit(ds.prefetch(2)))

    # The step's kernels on the first batch's own block.
    it = ds.prefetch(2).iterate()
    first = next(it)
    it.close()
    col = first._raw_column("features")
    if not isinstance(col, SortedSparseColumn) or not col.indices_are_sorted:
        fail(f"sorted stream: the prefetched column is {type(col).__name__}")
    ib, vb, perm, seg = col.indices, col.buf, col.perm, col.segment_ids
    w = torch.from_numpy(np.asarray(coef, np.float32)).cuda()
    got = kspmv.spmv(ib, vb, w)
    want = kspmv.spmv_plain(ib, vb, w)
    torch.cuda.synchronize()
    check_close("sorted stream: spmv vs plain", got, want, 1e-5, 1e-5)
    spmv_err = max_err(got, want)
    spmv_ms = timer(lambda: kspmv.spmv(ib, vb, w))
    spmv_plain_ms = timer(lambda: kspmv.spmv_plain(ib, vb, w))
    cells = ib.numel()
    touched = int(torch.unique(ib).numel())
    spmv_bound, spmv_by = bound_ms(cells * 8 + touched * 4 + ib.shape[0] * 4,
                                   2.0 * cells, "float32")
    mult = torch.randn(ib.shape[0], device="cuda")
    contrib = (vb * mult[:, None]).reshape(-1)
    gathered = contrib.index_select(0, perm)
    seg_host, vals_host = seg.cpu().numpy(), gathered.cpu().numpy()
    # The padded block's sorted sum takes ≈ 250 ms: 3 timed calls, not 20.
    block = segsum_case(torch, lambda fn, **kw: timer(fn, warmup=1, iters=3),
                        seg_host, vals_host, dim, "float32", True, 1e-5, 1e-5)
    # The same block without its padding run: the real cells alone, and
    # the same cell count with the padding cells' ids spread over dim.
    nnz_rows = np.diff(col.indptr.cpu().numpy())
    flat = perm.cpu().numpy().astype(np.int64)
    width = ib.shape[1]
    real = (flat % width) < nnz_rows[flat // width]
    unpadded = segsum_case(torch, timer, seg_host[real], vals_host[real],
                           dim, "float32", True, 1e-5, 1e-5)
    spread_ids = seg_host.copy()
    spread_ids[~real] = np.random.default_rng(8).integers(
        0, dim, size=int((~real).sum()))
    order = np.argsort(spread_ids, kind="stable")
    spread = segsum_case(torch, timer, spread_ids[order].astype(np.int32),
                         vals_host[order], dim, "float32", True, 1e-5, 1e-5)
    rec = {"path": "sorted_stream_H2", "rows": n, "dim": dim, "nnz": nnz,
           "batches": SORTED_BATCHES, "batch_rows": SORTED_ROWS,
           "epochs": SORTED_EPOCHS, "ell_width": int(width),
           "cells_per_batch": cells,
           "padding_cells_per_batch": int((~real).sum()),
           "fit_s": fit_s, "samples_per_s": n * SORTED_EPOCHS / fit_s,
           "epoch_s": epoch_s,
           "epoch0_samples_per_s": n / epoch_s[0],
           "replay_epochs_samples_per_s": n * (SORTED_EPOCHS - 1)
           / sum(epoch_s[1:]),
           "device_share": share,
           "spmv_ms_per_batch": spmv_ms, "spmv_plain_ms": spmv_plain_ms,
           "spmv_bound_ms": spmv_bound, "spmv_bound_by": spmv_by,
           "spmv_max_abs_err": spmv_err,
           "segment_sum_sorted_ms_per_batch": block["ms"],
           "segment_sum_sorted_bound_ms": block["bound_ms"],
           "segment_sum_sorted_plain_ms": block["plain_ms"],
           "segment_sum_sorted_library_ms": block["library_ms"],
           "segment_sum_sorted_bitwise_in_order": block["bitwise_in_order"],
           "segment_sum_real_cells_ms": unpadded["ms"],
           "segment_sum_real_cells_bound_ms": unpadded["bound_ms"],
           "segment_sum_spread_padding_ms": spread["ms"],
           "rel_err": errs, "launches": counts}
    log("path " + json.dumps(rec))
    return counts


def elastic_path(torch):
    """Path H3: ``OnlineLogisticRegression.fit_stream`` (path G's
    hyper-parameters) over an ``ElasticFeed`` of 64 seeded batches of
    16,384 x 123 float32 rows (``Dataset.synthetic`` per shard, a
    post-merge ``.shuffle(4)``): a run at world 4 with a checkpoint every
    16 batches that stops at batch 32 (a post-merge ``map`` raises there),
    resumed at world 2 (``rescale="allow"``), must equal the uninterrupted
    world-1 run bit for bit (cuBLAS, no atomics), its snapshot's cursor
    recording 4 shards; the model against a float64 numpy FTRL over the
    same batches in the same order (1e-4 of the largest coefficient)."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.data import Dataset, ElasticFeed
    from flinkml_tpu_torch.iteration import CheckpointManager

    true = np.random.default_rng(13).normal(size=FTRL_D)

    def make_batch(i, rng):
        xb = rng.normal(size=(FTRL_ROWS, FTRL_D)).astype(np.float32)
        return fml.Table({"features": xb,
                          "label": (xb @ true > 0).astype(np.float32),
                          "i": np.full(FTRL_ROWS, float(i), np.float32)})

    def feed(world):
        return ElasticFeed(
            lambda shard: Dataset.synthetic(make_batch, FTRL_BATCHES,
                                            seed=14, shard=shard),
            world).shuffle(ELASTIC_SHUFFLE, seed=15)

    order = shuffled_order(FTRL_BATCHES, ELASTIC_SHUFFLE, 15)

    def crash(t):
        if float(t.column("i")[0]) == order[FTRL_CRASH]:
            raise RuntimeError("injected crash")
        return t

    def est():
        return (fml.OnlineLogisticRegression().set_alpha(FTRL_ALPHA)
                .set_beta(FTRL_BETA).set_reg(FTRL_REG)
                .set_elastic_net(FTRL_EN))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    golden = est().fit_stream(feed(1))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=10)
        try:
            est().fit_stream(feed(ELASTIC_WORLD).map(crash),
                             checkpoint_manager=mgr,
                             checkpoint_interval=FTRL_INTERVAL)
            fail("elastic: the injected crash did not happen")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        if mgr.latest_epoch() != FTRL_CRASH:
            fail(f"elastic: the stopped run's newest snapshot is "
                 f"{mgr.latest_epoch()}")
        cursor = mgr.read_extra(FTRL_CRASH)["data_cursor"]
        if (cursor["emitted"], cursor["num_shards"]) != \
                (FTRL_CRASH, ELASTIC_WORLD):
            fail(f"elastic: the snapshot's cursor is {cursor}")
        resume_mgr = CheckpointManager(os.path.join(tmp, "ckpt"),
                                       max_to_keep=10, rescale="allow")
        t0 = time.perf_counter()
        resumed = est().fit_stream(feed(ELASTIC_RESUME_WORLD),
                                   checkpoint_manager=resume_mgr,
                                   checkpoint_interval=FTRL_INTERVAL,
                                   resume=True)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        restored_shards = resume_mgr.last_restored_extra["data_cursor"][
            "num_shards"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if restored_shards != ELASTIC_WORLD:
        fail(f"elastic: the restored cursor records {restored_shards} shards")
    if (golden.model_version, resumed.model_version) != \
            (FTRL_BATCHES, FTRL_BATCHES):
        fail(f"elastic: versions {golden.model_version}, "
             f"{resumed.model_version}")
    exact = bool(np.array_equal(resumed.coefficient, golden.coefficient))
    if not exact:
        fail("elastic: the world-2 resume differs from the uninterrupted "
             f"run by {rel_err(resumed.coefficient, golden.coefficient)}")
    parts = []
    for gi in order:
        t = make_batch(gi, np.random.default_rng([14, gi]))
        parts.append((t.column("features"), t.column("label")))
    err = rel_err(golden.coefficient, numpy_ftrl(
        parts, FTRL_ALPHA, FTRL_BETA, FTRL_REG * FTRL_EN,
        FTRL_REG * (1.0 - FTRL_EN)))
    if not np.isfinite(err) or err > 1e-4:
        fail(f"elastic: coefficient differs from float64 numpy by {err} of "
             "the largest (limit 1e-4)")
    log("path " + json.dumps({
        "path": "elastic_H3", "batches": FTRL_BATCHES,
        "batch_rows": FTRL_ROWS, "d": FTRL_D, "stopped_world": ELASTIC_WORLD,
        "resumed_world": ELASTIC_RESUME_WORLD, "stopped_at": FTRL_CRASH,
        "restored_cursor_shards": restored_shards, "fit_s": fit_s,
        "samples_per_s": FTRL_BATCHES * FTRL_ROWS / fit_s,
        "resume_s": resume_s, "resume_bit_exact": exact, "rel_err": err}))


# -- path I: the cumsum layout with BatchedCSR, the rest of KMeans -----------------

#: I1: BatchedCSR at the serving shape of Criteo rows.
CSR_ROWS = 65_536
#: I2: MNIST's width, 4 batches of 65,536 rows (0.8 GB of float32; 16
#: until path L's references ran after its ranks, 8 until path N joined), the cache's memory
#: budget at half of it; k = 10, 2 Lloyd epochs (20 until path J joined
#: the run, 10 until path K did, 6 until path L did, 4 until path U), a
#: checkpoint every epoch, a crash at 1.
KMS_BATCHES, KMS_ROWS, KMS_D, KMS_K = 4, 65_536, 784, 10
KMS_EPOCHS, KMS_INTERVAL, KMS_CRASH = 2, 1, 1  # 4, 2, 2 until path U
#: I3: 16 batches of 16,384 drifting MNIST-width rows (64 until path L's
#: references ran after its ranks, 32 until path M joined the run), k = 10,
#: decay 0.9, a checkpoint every 4 batches, a crash at 8.
OKM_BATCHES, OKM_ROWS, OKM_D, OKM_K = 16, 16_384, 784, 10
OKM_DECAY, OKM_INTERVAL, OKM_CRASH = 0.9, 4, 8


def cumsum_path(torch, timer):
    """Path I1: ``train_linear_model_sparse_csr(layout="cumsum")`` at the
    sparse fit path's shape (262,144 Criteo rows, dim 1e6, 39 draws a row,
    batch 262,144, ``FIT_EPOCHS``): the ``spmv`` kernel forward, chunked
    running sums and one ``index_add_`` a step. Held against float64 numpy
    and against the ``unsorted`` fit (1e-4 of the largest coefficient);
    the host tables and the device loop timed apart; two runs of the loop
    equal bit for bit (no atomics), and so is a loop stopped at epoch 10
    and resumed from its checkpoint. Then ``BatchedCSR.matvec`` (``spmv``)
    and ``rmatvec`` (``segment_sum``) at 65,536 Criteo rows against their
    plain versions. Returns the launch counts of the fit and the two
    calls."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.kernels.segsum import segment_sum_plain
    from flinkml_tpu_torch.kernels.spmv import spmv_plain
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.ops import BatchedCSR

    n, dim, nnz = SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ
    if FIT_BATCH < n:
        fail("cumsum fit: the full-batch numpy reference needs batch >= rows")
    indptr, indices, values, y, w = make_criteo_csr(n, dim, nnz, seed=0)
    csr = (indptr, indices, values, dim, y, w)
    hyper = ("logistic", FIT_EPOCHS, FIT_LR, FIT_BATCH, 0.0, 0.0, 0.0, 0)
    fml.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coef = sgd.train_linear_model_sparse_csr(*csr, *hyper, layout="cumsum")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    m = CSR_ROWS
    batch = BatchedCSR(indices[:m * nnz].reshape(m, nnz),
                       values[:m * nnz].reshape(m, nnz), dim)
    rng = np.random.default_rng(61)
    wv = torch.from_numpy(rng.normal(size=dim).astype(np.float32)).cuda()
    cv = torch.from_numpy(rng.normal(size=m).astype(np.float32)).cuda()
    mv, rmv = batch.matvec(wv), batch.rmatvec(cv)
    torch.cuda.synchronize()
    counts = fml.launch_counts()
    if counts["spmv"] < FIT_EPOCHS + 1 or counts["segment_sum"] < 1:
        fail(f"cumsum path: kernel launches {counts} (the fit's {FIT_EPOCHS} "
             "steps, one matvec and one rmatvec)")

    check_close("BatchedCSR.matvec", mv,
                spmv_plain(batch.indices, batch.values, wv), 1e-5, 1e-5)
    contrib = (batch.values * cv[:, None]).reshape(-1)
    flat_ids = batch.indices.reshape(-1)
    rmv_plain = segment_sum_plain(contrib, flat_ids, dim)
    rmv_err = max_err(rmv, rmv_plain)
    if not rmv_err <= 1e-5 * float(rmv_plain.abs().max()):
        fail(f"BatchedCSR.rmatvec: max abs err {rmv_err} beyond 1e-5 of the "
             "largest sum")
    csr_ms = {"matvec_ms": timer(lambda: batch.matvec(wv)),
              "matvec_plain_ms": timer(lambda: spmv_plain(
                  batch.indices, batch.values, wv)),
              "rmatvec_ms": timer(lambda: batch.rmatvec(cv)),
              "rmatvec_plain_ms": timer(lambda: segment_sum_plain(
                  (batch.values * cv[:, None]).reshape(-1), flat_ids, dim))}
    del batch, wv, cv, mv, rmv, contrib, flat_ids, rmv_plain

    # The host tables apart from the device loop.
    tables_s = []
    real_tables = sgd._window_cumsum_tables

    def timed_tables(*a):
        t1 = time.perf_counter()
        out = real_tables(*a)
        tables_s.append(time.perf_counter() - t1)
        return out

    sgd._window_cumsum_tables = timed_tables
    try:
        t0 = time.perf_counter()
        data_args, local_bss = sgd.prepare_sparse_buckets(
            indptr, indices, values, dim, y, w, FIT_BATCH, seed=0,
            layout="cumsum")
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
    finally:
        sgd._window_cumsum_tables = real_tables
    trainer = sgd._sparse_trainer_bucketed("logistic", local_bss, dim,
                                           "cumsum")

    def loop(epochs=FIT_EPOCHS, **ckpt):
        return sgd._run_chunked(trainer, data_args, dim, torch.float32,
                                FIT_LR, 0.0, 0.0, 0.0, epochs, **ckpt)

    _, loop_s, second = timed_calls(torch, loop, calls=1)
    runs_equal = bool(np.array_equal(second, coef))
    if not runs_equal:
        fail("cumsum fit: two runs differ by "
             f"{float(np.abs(second - coef).max())}")
    share = device_share(torch, loop)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cumsum_")
    try:
        half = FIT_EPOCHS // 2
        ckpt = dict(checkpoint_manager=CheckpointManager(tmp),
                    checkpoint_interval=half)
        loop(half, **ckpt)
        resumed = loop(resume=True, **ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resume_exact = bool(np.array_equal(resumed, coef))
    if not resume_exact:
        fail("cumsum fit: the resumed loop differs from the uninterrupted "
             f"fit by {float(np.abs(resumed - coef).max())}")
    del data_args

    ref = numpy_sparse_fit(indptr, indices, values, dim, y, w, FIT_EPOCHS,
                           FIT_LR)
    t0 = time.perf_counter()
    unsorted = sgd.train_linear_model_sparse_csr(*csr, *hyper,
                                                 layout="unsorted")
    torch.cuda.synchronize()
    unsorted_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    errs = {"float64_numpy": float(np.abs(coef - ref).max()),
            "unsorted": float(np.abs(coef - unsorted).max())}
    for name, err in errs.items():
        if not err <= 1e-4 * scale:
            fail(f"cumsum fit: coefficient differs from {name} by {err} "
                 f"(limit 1e-4 of {scale})")
    samples = FIT_BATCH * FIT_EPOCHS
    log("path " + json.dumps({
        "path": "cumsum_I1", "rows": n, "dim": dim, "nnz": nnz,
        "batch": FIT_BATCH, "epochs": FIT_EPOCHS, "fit_s": fit_s,
        "samples_per_s": samples / fit_s, "prepare_s": prep_s,
        "window_cumsum_tables_s": sum(tables_s), "buckets": len(local_bss),
        "device_loop_s": loop_s, "loop_samples_per_s": samples / loop_s,
        "loop_device_share": share, "runs_bit_equal": runs_equal,
        "resume_bit_exact": resume_exact,
        "unsorted_fit_s": unsorted_s, "max_abs_coef_err": errs,
        "max_abs_coef": scale, "csr_rows": m, "rmatvec_max_abs_err": rmv_err,
        **csr_ms, "launches": counts}))
    return counts


def kmeans_stream_path(torch):
    """Path I2: ``KMeans().fit`` (k-means++ init) over an iterable of
    ``KMS_BATCHES`` Tables of 65,536 x 784 float32 blobs around k = 10
    centres far apart (so that no row lies near an assignment boundary
    once each centre has a centroid), the cache's memory budget at half of
    their bytes so that half spills, ``KMS_EPOCHS`` Lloyd epochs with a checkpoint every
    ``KMS_INTERVAL``. A fit from a sealed cache of the same batches crashed
    at epoch ``KMS_CRASH`` and resumed equals the uninterrupted one bit
    for bit (the
    one-hot product, no atomics); against the in-RAM ``train_kmeans``
    from the same initial centroids within 1e-5 of the largest
    coordinate. The model then serves behind a StandardScaler through the
    fused executor (``fused_chain``), its assignments against the
    per-stage path's and the plain chain's away from near ties. Returns
    the serving's launch counts. The record is logged before a failed
    check fails the path."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.models import kmeans as tkm

    rng = np.random.default_rng(31)
    centers = (rng.normal(size=(KMS_K, KMS_D)) * 100.0).astype(np.float32)
    batches = []
    for _ in range(KMS_BATCHES):
        x = rng.standard_normal((KMS_ROWS, KMS_D), dtype=np.float32)
        x += centers[rng.integers(0, KMS_K, size=KMS_ROWS)]
        batches.append(x)
    budget = sum(x.nbytes for x in batches) // 2
    tables = [fml.Table({"features": x}) for x in batches]

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            out = super().save(state, epoch, extra, **kw)
            if epoch == KMS_CRASH:
                raise RuntimeError("injected crash")
            return out

    def est(**kw):
        return (fml.KMeans(**kw).set_k(KMS_K).set_max_iter(KMS_EPOCHS)
                .set_seed(0).set_init_mode("k-means++"))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kmeans_")
    try:
        with FeedWaits() as feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est(cache_dir=os.path.join(tmp, "c1"),
                        cache_memory_budget_bytes=budget,
                        checkpoint_manager=CheckpointManager(
                            os.path.join(tmp, "k1"), max_to_keep=10),
                        checkpoint_interval=KMS_INTERVAL).fit(iter(tables))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        spilled = len(os.listdir(os.path.join(tmp, "c1")))
        writer = DataCacheWriter(os.path.join(tmp, "c2"), budget)
        for x in batches:
            writer.append({"features": x.copy()})   # the cache freezes RAM
        cache = writer.finish()
        crash = Crash(os.path.join(tmp, "k2"), max_to_keep=10)
        try:
            est(checkpoint_manager=crash,
                checkpoint_interval=KMS_INTERVAL).fit(cache)
            fail("kmeans stream: the injected crash did not happen")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        if crash.latest_epoch() != KMS_CRASH:
            fail(f"kmeans stream: the crashed run's newest snapshot is "
                 f"{crash.latest_epoch()}")
        box = {}

        def resume():
            box["model"] = est(
                checkpoint_manager=CheckpointManager(
                    os.path.join(tmp, "k2"), max_to_keep=10),
                checkpoint_interval=KMS_INTERVAL, resume=True).fit(cache)

        t0 = time.perf_counter()
        share = device_share(torch, resume)
        resume_s = time.perf_counter() - t0
        init = tkm.train_kmeans_stream(cache, KMS_K, max_iter=0, seed=0,
                                       init_mode="k-means++",
                                       column="features")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    problems = []
    exact = bool(np.array_equal(box["model"].centroids, model.centroids))
    if not exact:
        problems.append(
            "the resumed fit differs from the uninterrupted one by "
            f"{rel_err(box['model'].centroids, model.centroids)}")
    x_all = np.concatenate(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = tkm.train_kmeans(x_all, KMS_K, max_iter=KMS_EPOCHS,
                             initial_centroids=init)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    del x_all
    err = rel_err(model.centroids, whole)
    if not np.isfinite(err) or err > 1e-5:
        problems.append(f"centroids differ from the in-RAM fit by {err} of "
                        "the largest (limit 1e-5)")
    # Each centre's blob has one centroid: the nearest centroid of every
    # centre is distinct.
    nearest = np.argmin(((centers[:, None, :] - model.centroids[None]) ** 2)
                        .sum(-1), axis=1)
    blobs_found = int(np.unique(nearest).size)

    # Served behind a StandardScaler, the centroids in the scaled space.
    scaler = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(tables[0]))
    (sdata,) = scaler.get_model_data()
    mean, std = sdata.column("mean")[0], sdata.column("std")[0]
    served = fml.KMeansModel().set_features_col("s").set_model_data(
        fml.Table({"centroids": ((model.centroids - mean) / std)[None]}))
    pipe = fml.PipelineModel([scaler, served])
    table = tables[1]

    def run():
        (out,) = pipe.transform(table)
        return out.column("prediction")

    pipeline_fusion.reset_cache()
    fml.reset_launch_counts()
    _, call_s, pred = timed_calls(torch, run)
    counts = fml.launch_counts()
    if counts["fused_chain"] < 4:
        problems.append(f"serving: fused_chain launched "
                        f"{counts['fused_chain']} times in 4 transforms")
    pipeline_fusion.set_enabled(False)
    try:
        _, per_stage_s, per_stage = timed_calls(torch, run, calls=1)
    finally:
        pipeline_fusion.set_enabled(True)
    kernels = [st.transform_kernel() for st in pipe.stages]
    xd = torch.from_numpy(batches[1]).cuda()
    want = kchain.chain_plain(kernels, ["features"], ["s", "prediction"],
                              [xd], [kk.constants for kk in kernels],
                              KMS_ROWS)
    c = torch.from_numpy(served.centroids).cuda()
    ok = _gap_ok(-(torch.cdist(want["s"].double(), c) ** 2).cpu().numpy())
    plain = want["prediction"].cpu().numpy()
    for name, got in (("fused", pred), ("per-stage", per_stage)):
        if not np.array_equal(got[ok], plain[ok]):
            problems.append(f"serving: {name} assignments differ from the "
                            "plain chain away from near ties")
    del xd, want
    points = KMS_BATCHES * KMS_ROWS
    log("path " + json.dumps({
        "path": "kmeans_stream_I2", "batches": KMS_BATCHES,
        "batch_rows": KMS_ROWS, "d": KMS_D, "k": KMS_K, "epochs": KMS_EPOCHS,
        "cache_budget_bytes": budget, "spilled_segments": spilled,
        "fit_s": fit_s, "points_per_s": points * KMS_EPOCHS / fit_s,
        "epoch_s": feeds.spans, "feed_wait_s": feeds.waits,
        "epoch_points_per_s": [points / t for t in feeds.spans],
        "resume_epochs": KMS_EPOCHS - KMS_CRASH, "resume_s": resume_s,
        "resume_device_share": share, "resume_bit_exact": exact,
        "in_ram_fit_s": whole_s, "rel_err_vs_in_ram": err,
        "blobs_found": blobs_found, "serve_rows": KMS_ROWS,
        "fused_call_s": call_s, "per_stage_call_s": per_stage_s,
        "rows_within_tie_margin": int((~ok).sum()), "launches": counts}))
    if problems:
        fail("kmeans stream: " + "; ".join(problems))
    return counts


def numpy_online_kmeans(batches, centroids, decay):
    """Float64 numpy decay rule over ``batches`` from ``centroids``."""
    c = np.asarray(centroids, np.float64).copy()
    weights = np.zeros(c.shape[0])
    for x in batches:
        x64 = x.astype(np.float64)
        d2 = ((x64 * x64).sum(1)[:, None] - 2.0 * x64 @ c.T
              + (c * c).sum(1)[None, :])
        onehot = np.eye(c.shape[0])[d2.argmin(1)]
        old = weights * decay
        new = old + onehot.sum(0)
        upd = (old[:, None] * c + onehot.T @ x64) / np.maximum(new, 1e-12)[
            :, None]
        c = np.where(new[:, None] > 0, upd, c)
        weights = new
    return c


def online_kmeans_path(torch):
    """Path I3: ``OnlineKMeans.fit_stream`` over ``OKM_BATCHES`` seeded
    batches of 16,384 x 784 rows drawn around 10 centres that drift a
    little each batch, warm-started near the first centres, decay 0.9, a
    checkpoint every ``OKM_INTERVAL`` batches; a run crashed at batch
    ``OKM_CRASH`` and resumed (``replay``)
    equals the uninterrupted one bit for bit; against a float64 numpy
    decay rule within 1e-9 of the largest coordinate."""
    import shutil

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager

    rng = np.random.default_rng(51)
    centers0 = rng.normal(size=(OKM_K, OKM_D)) * 4.0
    drift = rng.normal(size=(OKM_K, OKM_D)) * 0.05
    batches = []
    for i in range(OKM_BATCHES):
        x = rng.standard_normal((OKM_ROWS, OKM_D), dtype=np.float32)
        x += (centers0 + i * drift).astype(np.float32)[
            rng.integers(0, OKM_K, size=OKM_ROWS)]
        batches.append(x)
    tables = [fml.Table({"features": x}) for x in batches]
    init = centers0 + rng.normal(size=centers0.shape) * 0.5

    def est():
        return (fml.OnlineKMeans().set_k(OKM_K).set_decay_factor(OKM_DECAY)
                .set_initial_model_data(fml.Table({"centroids": init[None]})))

    def crashing():
        for i, t in enumerate(tables):
            if i == OKM_CRASH:
                raise RuntimeError("injected crash")
            yield t

    est().fit_stream(tables[:2])   # first fit: cuBLAS and allocator warm
    tmp = tempfile.mkdtemp(prefix="chip_smoke_okm_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est().fit_stream(
            tables, checkpoint_manager=CheckpointManager(
                os.path.join(tmp, "main"), max_to_keep=10),
            checkpoint_interval=OKM_INTERVAL)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        crash = CheckpointManager(os.path.join(tmp, "crash"), max_to_keep=10)
        try:
            est().fit_stream(crashing(), checkpoint_manager=crash,
                             checkpoint_interval=OKM_INTERVAL)
            fail("online kmeans: the injected crash did not happen")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        if crash.latest_epoch() != OKM_CRASH:
            fail(f"online kmeans: the crashed run's newest snapshot is "
                 f"{crash.latest_epoch()}")
        resumed = est().fit_stream(tables, checkpoint_manager=crash,
                                   checkpoint_interval=OKM_INTERVAL,
                                   resume=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    problems = []
    if (model.model_version, resumed.model_version) != \
            (OKM_BATCHES, OKM_BATCHES):
        problems.append(f"versions {model.model_version}, "
                        f"{resumed.model_version}")
    exact = bool(np.array_equal(resumed.centroids, model.centroids))
    if not exact:
        problems.append("the resumed run differs from the uninterrupted one "
                        f"by {rel_err(resumed.centroids, model.centroids)}")
    err = rel_err(model.centroids,
                  numpy_online_kmeans(batches, init, OKM_DECAY))
    if not np.isfinite(err) or err > 1e-9:
        problems.append(f"centroids differ from float64 numpy by {err} of "
                        "the largest (limit 1e-9)")
    log("path " + json.dumps({
        "path": "online_kmeans_I3", "batches": OKM_BATCHES,
        "batch_rows": OKM_ROWS, "d": OKM_D, "k": OKM_K, "decay": OKM_DECAY,
        "fit_s": fit_s, "batches_per_s": OKM_BATCHES / fit_s,
        "samples_per_s": OKM_BATCHES * OKM_ROWS / fit_s,
        "checkpoints": list(range(OKM_INTERVAL, OKM_BATCHES + 1,
                                  OKM_INTERVAL)),
        "resume_bit_exact": exact,
        "rel_err": err}))
    if problems:
        fail("online kmeans: " + "; ".join(problems))


def slice_i_path(torch, timer):
    """Path I as a whole: I1, I2 and I3, which must launch ``spmv``,
    ``segment_sum`` and ``fused_chain``. Returns the summed counts."""
    t0 = time.perf_counter()
    counts = dict(cumsum_path(torch, timer))
    for name, n in kmeans_stream_path(torch).items():
        counts[name] = counts.get(name, 0) + n
    online_kmeans_path(torch)
    missing = [k for k in ("spmv", "segment_sum", "fused_chain")
               if not counts.get(k)]
    if missing:
        fail(f"path I: {missing} never launched ({counts})")
    log(f"path I: {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


# -- path J: the data-parallel fits on a mesh -----------------------------------------

#: J1's KMeans cell (path 9's second: 262,144 x 128, k = 64), 20 epochs.
MESH_KMEANS_N, MESH_KMEANS_D, MESH_KMEANS_K, MESH_KMEANS_ITERS = (
    262_144, 128, 64, 20)
#: J2: two ranks on the one card over gloo, within one deadline.
J2_WORLD, J2_TIMEOUT_S = 2, 420
#: Path J's device and backends (world 1: nccl; two ranks on one card:
#: gloo over CUDA tensors).
J_DEVICE, J1_BACKEND, J2_BACKEND = "cuda", "nccl", "gloo"
#: Path J's fits: 2 epochs (6 until path N joined the run, 4 until path
#: O), fewer than ``FIT_EPOCHS`` (20), so that the whole script stays
#: within its time budget.
J_EPOCHS = 2


def _sync(torch):
    if J_DEVICE == "cuda":
        torch.cuda.synchronize()


def _seconds(torch, fn):
    """``(seconds, result)`` of one call on the host clock, synchronized."""
    _sync(torch)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch)
    return time.perf_counter() - t0, out


def all_reduce_ms(torch, mesh, numel, calls=10):
    """Host-clock milliseconds of one ``all_reduce`` of ``numel`` float32
    over the mesh's data axis (the fit step's flat ``[grad | loss_sum |
    wsum]`` buffer), synchronized, the mean of ``calls`` after 3 warm-up
    calls."""
    from flinkml_tpu_torch.parallel.collectives import all_reduce_

    buf = torch.ones(numel, dtype=torch.float32, device=mesh.device)
    for _ in range(3):
        all_reduce_(mesh, buf)
    buf.fill_(1.0)
    secs, _ = _seconds(torch, lambda: [all_reduce_(mesh, buf)
                                       for _ in range(calls)])
    return secs / calls * 1e3


def mesh_data():
    """Path J's seeded inputs: path B's Criteo CSR, path 5's dense rows,
    J1's KMeans points (standard normal float32)."""
    return {"csr": make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ,
                                   seed=0),
            "dense": make_data(DENSE_FIT_ROWS, DENSE_FIT_D),
            "points": np.random.default_rng(0).standard_normal(
                (MESH_KMEANS_N, MESH_KMEANS_D)).astype(np.float32)}


def mesh_fits(torch, mesh, data):
    """The fits of path J over ``mesh`` (None: no mesh) on :func:`mesh_data`:
    the sparse LR fit at path B's width in the ``unsorted`` and ``sorted``
    layouts, the dense LR fit (``LogisticRegression(mesh=...)``), the
    KMeans fit (``KMeans(mesh=...)``). Returns ``{name: (result,
    seconds)}``."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    out = {}
    indptr, indices, values, y, w = data["csr"]
    for layout in ("unsorted", "sorted"):
        secs, coef = _seconds(torch, lambda: sgd.train_linear_model_sparse_csr(
            indptr, indices, values, SPMV_DIM, y, w, "logistic", J_EPOCHS,
            FIT_LR, FIT_BATCH, 0.0, 0.0, 0.0, 0, layout=layout, mesh=mesh))
        out[f"sparse_{layout}"] = (coef, secs)
    x, yd, _ = data["dense"]
    table = fml.Table({"features": x, "label": yd})
    est = (fml.LogisticRegression(mesh=mesh).set_seed(0).set_tol(0.0)
           .set_global_batch_size(FIT_BATCH).set_max_iter(J_EPOCHS)
           .set_learning_rate(FIT_LR))
    secs, model = _seconds(torch, lambda: est.fit(table))
    out["dense"] = (model.coefficient, secs)
    km = (fml.KMeans(mesh=mesh).set_k(MESH_KMEANS_K).set_seed(0)
          .set_max_iter(MESH_KMEANS_ITERS))
    secs, kmodel = _seconds(torch, lambda: km.fit(
        fml.Table({"features": data["points"]})))
    out["kmeans"] = (kmodel.centroids, secs)
    return out


def mesh_world1(torch, data, plain, refs):
    """J1: ``init_distributed`` at world 1 over ``J1_BACKEND`` (nccl)
    through a ``file://`` store in a temporary directory, then
    :func:`mesh_fits` with ``mesh=DeviceMesh()``: each fit equal to the same
    fit without a mesh (``plain``) bit for bit, but the ``unsorted`` sparse
    fit, whose ``segment_sum`` adds by atomics in a run-dependent order
    (within 1e-5 of its largest coefficient, as two fits without a mesh
    are); the sparse and dense fits against float64 numpy (1e-4 of the
    largest coefficient). Returns the record."""
    import tempfile

    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import distributed as pdist

    with tempfile.TemporaryDirectory() as tmp:
        pdist.init_distributed("file://" + os.path.join(tmp, "store"), 1, 0,
                               backend=J1_BACKEND, timeout_s=300)
        try:
            mesh = DeviceMesh()
            if mesh.group() is None:
                fail("path J1: the world-1 mesh has no process group")
            meshed = mesh_fits(torch, mesh, data)
            ar_ms = all_reduce_ms(torch, mesh, SPMV_DIM + 2)
        finally:
            pdist.shutdown_distributed()
    rec = {"all_reduce_ms_per_step": ar_ms, "backend": J1_BACKEND,
           "fit_s_mesh": {k: v[1] for k, v in meshed.items()},
           "fit_s_no_mesh": {k: v[1] for k, v in plain.items()},
           "bit_for_bit": {}, "max_abs_diff_vs_no_mesh": {}}
    for name, (want, _) in plain.items():
        got = meshed[name][0]
        rec["bit_for_bit"][name] = bool(np.array_equal(got, want))
        rec["max_abs_diff_vs_no_mesh"][name] = float(np.abs(got - want).max())
        if name == "sparse_unsorted":
            if not rec["max_abs_diff_vs_no_mesh"][name] <= 1e-5 * np.abs(
                    want).max():
                fail(f"path J1: the unsorted mesh fit differs from the fit "
                     f"without a mesh by {rec['max_abs_diff_vs_no_mesh'][name]}")
        elif not rec["bit_for_bit"][name]:
            fail(f"path J1: {name} on the world-1 mesh differs from the fit "
                 f"without a mesh by {rec['max_abs_diff_vs_no_mesh'][name]}")
    for name, ref in (("sparse_unsorted", refs["sparse"]),
                      ("sparse_sorted", refs["sparse"]),
                      ("dense", refs["dense1"])):
        err = float(np.abs(meshed[name][0] - ref).max())
        rec.setdefault("max_abs_err_vs_float64", {})[name] = err
        if not err <= 1e-4 * np.abs(ref).max():
            fail(f"path J1: {name} differs from float64 numpy by {err}")
    step_s = meshed["sparse_sorted"][1] / J_EPOCHS
    rec["all_reduce_share_of_sparse_step"] = ar_ms / 1e3 / step_s
    return rec


def j2_rank(out_dir: str) -> int:
    """One rank of J2 (``chip_smoke.py --j2-rank OUT_DIR``, started by
    :func:`mesh_world2`): joins the group over ``J2_BACKEND`` with CUDA
    tensors on the current card, runs the sparse LR fit (``unsorted``) at
    path B's width and the dense LR fit on a mesh of every rank, then
    ``keyed_aggregate`` of the sparse fit's cells (262,144 x 39 values by
    column into 1e6 segments), then paths K2 (:func:`k2_rank`) and L
    (:func:`l_rank`, its launches counted apart); writes its results,
    times and launch counts to ``OUT_DIR/rank<r>.npz``."""
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.parallel import DeviceMesh, keyed_aggregate
    from flinkml_tpu_torch.parallel import distributed as pdist

    fml.set_default_device(J_DEVICE)
    rank, world = pdist.init_distributed(backend=J2_BACKEND, timeout_s=300)
    try:
        mesh = DeviceMesh()
        fml.reset_launch_counts()
        indptr, indices, values, y, w = make_criteo_csr(
            SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ, seed=0)
        sparse_s, sparse = _seconds(torch, lambda: sgd.train_linear_model_sparse_csr(
            indptr, indices, values, SPMV_DIM, y, w, "logistic", J_EPOCHS,
            FIT_LR, FIT_BATCH, 0.0, 0.0, 0.0, 0, layout="unsorted", mesh=mesh))
        x, yd, _ = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
        est = (fml.LogisticRegression(mesh=mesh).set_seed(0).set_tol(0.0)
               .set_global_batch_size(FIT_BATCH).set_max_iter(J_EPOCHS)
               .set_learning_rate(FIT_LR))
        dense_s, model = _seconds(torch, lambda: est.fit(
            fml.Table({"features": x, "label": yd})))
        keyed_s, keyed = _seconds(torch, lambda: keyed_aggregate(
            mesh, values, indices, SPMV_DIM))
        counts = fml.launch_counts()
        ar_ms = all_reduce_ms(torch, mesh, SPMV_DIM + 2)
        k2 = k2_rank(torch, x, yd, out_dir)
        del x, yd
        l_out = l_rank(torch, mesh, rank, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), sparse=sparse,
                 dense=model.coefficient, keyed=keyed.cpu().numpy(),
                 seconds=np.asarray([sparse_s, dense_s, keyed_s]),
                 all_reduce_ms=np.asarray([ar_ms]),
                 launches=np.asarray([counts["spmv"], counts["segment_sum"]]),
                 rank_world=np.asarray([rank, world]),
                 device=np.asarray([mesh.device.index or 0]), **k2,
                 **l_out)
    finally:
        pdist.shutdown_distributed()
    return 0


def k2_rank(torch, x, y, out_dir):
    """Path K2 on one rank of J2 (two ranks on the one card over gloo):
    FSDP and FSDP_TP fits of path 5's rows with an intercept column
    (124 wide, so that ``fsdp`` = 2 divides ``coef``), the same fit over
    the 123 columns alone (refused: FML502), and an FSDP fit that
    snapshots every ``K2_STOP // 2`` epochs into ``OUT_DIR/k2_ckpt`` (the
    first rank writes) and stops at epoch ``K2_STOP`` through a scripted
    ``RankLost`` of rank 1 under a preemption watchdog on both ranks, then
    the survivors' elastic plan. Returns the arrays the rank saves."""
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding import (
        FSDP,
        FSDP_TP,
        PlanValidationError,
        train_linear_plan,
    )
    from flinkml_tpu_torch.utils.preemption import PreemptionWatchdog

    xk = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], 1)
    perm = np.random.default_rng(0).permutation(xk.shape[0])
    xp, yp = xk[perm], y[perm]
    fsdp_mesh, tp_mesh = DeviceMesh.for_plan(FSDP), DeviceMesh.for_plan(FSDP_TP)
    stats = {}
    fsdp_s, fsdp = _seconds(torch, lambda: train_linear_plan(
        xp, yp, None, FSDP, fsdp_mesh, stats=stats, **k_kw()))
    tp_s, fsdp_tp = _seconds(torch, lambda: train_linear_plan(
        xp, yp, None, FSDP_TP, tp_mesh, **k_kw()))
    try:
        train_linear_plan(x[perm], yp, None, FSDP, fsdp_mesh, **k_kw())
        refused = 0
    except PlanValidationError as e:
        refused = int("FML502" in str(e))
    mgr = CheckpointManager(os.path.join(out_dir, "k2_ckpt"), max_to_keep=10,
                            rescale="reshard")
    # The fit stops at K2_STOP through a scripted loss of rank 1, seen by
    # a watchdog on both ranks: a clean stop with a terminal snapshot.
    half_stats = {}
    wd = PreemptionWatchdog(signals=())
    with wd, faults.armed(faults.FaultPlan(
            faults.RankLost(epoch=K2_STOP, rank=1))):
        half_s, half = _seconds(torch, lambda: train_linear_plan(
            xp, yp, None, FSDP, fsdp_mesh, checkpoint_manager=mgr,
            checkpoint_interval=K2_STOP // 2, stats=half_stats, **k_kw()))
    elastic = wd.plan_elastic_resume(mgr, world=J2_WORLD)
    steps = max(stats["steps"], 1)
    return {"k2_fsdp": fsdp, "k2_fsdp_tp": fsdp_tp, "k2_half": half,
            "k2_preempted": np.asarray([int(half_stats["preempted"]),
                                        half_stats["epoch"],
                                        int(wd.shrink_requested)]),
            "k2_elastic": np.asarray([elastic.epoch, elastic.old_world,
                                      elastic.new_world]),
            "k2_refused": np.asarray([refused]),
            "k2_seconds": np.asarray([fsdp_s, tp_s, half_s]),
            "k2_collectives": np.asarray(
                [stats["collectives"]["all_gather"] / steps,
                 stats["collectives"]["all_reduce"] / steps])}


# -- path L: the streamed fits on several ranks (in J2's two ranks) -------------------

#: L1: the streamed sparse LR, Criteo profile, each rank its own partition:
#: rank r holds L_BATCHES[r] batches of L_ROWS[r] rows (uneven heights and
#: counts: padded rows and a dummy step), 2 epochs, a snapshot every epoch
#: into the shared directory, a crash at the end of epoch L_CRASH + 1.
L_BATCHES, L_ROWS = (4, 3), (65_536, 49_152)  # (6, 5) until path U
L_EPOCHS, L_CRASH = 2, 1  # 3, 2 until path U
#: L2: a dense streamed LinearSVC at a9a's width (123).
L_SVC_BATCHES, L_SVC_ROWS = (4, 3), (65_536, 49_152)
#: L3: a streamed KMeans at 784 wide, k = 10, k-means++ from the ranks'
#: pooled reservoirs (4 batches and 3 epochs until path N joined the run).
L_KM_BATCHES, L_KM_ROWS, L_KM_D, L_KM_K, L_KM_EPOCHS = 2, 65_536, 784, 10, 2
#: L4: FTRL (123 wide) and OnlineKMeans (784 wide) over these batches a
#: rank (16 until path N joined the run).
L_ON_BATCHES, L_ON_ROWS = 8, 16_384


def l_sparse(rank):
    """L1's partition of rank ``rank``: flat CSR dicts and host tuples."""
    n, rows = L_BATCHES[rank] * L_ROWS[rank], L_ROWS[rank]
    indptr, indices, values, y, _ = make_criteo_csr(n, SPMV_DIM, SPMV_NNZ,
                                                    seed=20 + rank)
    return csr_batch_dicts(indptr, indices, values, y, L_BATCHES[rank], rows,
                           SPMV_DIM)


def l_dense(rank):
    """L2's partition: ``(x, y)`` batches of path 5's planted a9a-width
    rows (one planted coefficient for every rank)."""
    true = np.random.default_rng(30).normal(size=DENSE_FIT_D)
    rng = np.random.default_rng(31 + rank)
    out = []
    for _ in range(L_SVC_BATCHES[rank]):
        x = rng.normal(size=(L_SVC_ROWS[rank], DENSE_FIT_D)).astype(
            np.float32)
        out.append((x, (x @ true > 0).astype(np.float32)))
    return out


def l_blobs(rank):
    """L3's partition: float32 rows around k centres 1,000 apart (the same
    centres on every rank)."""
    centres = (np.random.default_rng(40).normal(size=(L_KM_K, L_KM_D))
               * 1e3).astype(np.float32)
    rng = np.random.default_rng(41 + rank)
    out = []
    for _ in range(L_KM_BATCHES):
        x = rng.standard_normal((L_KM_ROWS, L_KM_D), dtype=np.float32)
        x += centres[rng.integers(0, L_KM_K, size=L_KM_ROWS)]
        out.append(x)
    return out


def l_online(rank):
    """L4's partitions: FTRL ``(x, y)`` batches at 123 wide, and
    OnlineKMeans batches at 784 wide around path I3's drifting centres,
    with I3's warm start."""
    true = np.random.default_rng(60).normal(size=FTRL_D)
    rng = np.random.default_rng(61 + rank)
    ftrl = []
    for _ in range(L_ON_BATCHES):
        x = rng.normal(size=(L_ON_ROWS, FTRL_D)).astype(np.float32)
        ftrl.append((x, (x @ true > 0).astype(np.float32)))
    crng = np.random.default_rng(51)
    centers0 = crng.normal(size=(OKM_K, OKM_D)) * 4.0
    drift = crng.normal(size=(OKM_K, OKM_D)) * 0.05
    init = centers0 + crng.normal(size=centers0.shape) * 0.5
    okm = []
    for i in range(L_ON_BATCHES):
        x = rng.standard_normal((L_ON_ROWS, OKM_D), dtype=np.float32)
        x += (centers0 + i * drift).astype(np.float32)[
            rng.integers(0, OKM_K, size=L_ON_ROWS)]
        okm.append(x)
    return ftrl, okm, init


def l_combined(parts):
    """The one-process stream of several ranks' partitions: step t joins
    every rank's batch t (tuples joined field by field)."""
    steps = max(len(p) for p in parts)
    out = []
    for t in range(steps):
        here = [p[t] for p in parts if t < len(p)]
        if isinstance(here[0], tuple):
            out.append(tuple(np.concatenate(f) for f in zip(*here)))
        else:
            out.append(np.concatenate(here))
    return out


def l_csr_steps(parts):
    """The one-process stream of several ranks' CSR partitions ``(indptr,
    indices, values, y, w)``: step t joins every rank's batch t."""
    out = []
    for t in range(max(len(p) for p in parts)):
        here = [p[t] for p in parts if t < len(p)]
        lens = np.concatenate([np.diff(h[0]) for h in here])
        out.append((np.concatenate([[0], np.cumsum(lens)]),)
                   + tuple(np.concatenate([h[i] for h in here])
                           for i in range(1, 5)))
    return out


def l_rank(torch, mesh, rank, out_dir):
    """Path L on one rank of J2 (every rank its own partition): L1 the
    streamed sparse LR from a ``DataCache`` spilling half its batches into
    this rank's directory, snapshots into the shared ``OUT_DIR/l_ckpt``,
    a run crashed at the end of epoch ``L_CRASH + 1`` and resumed, the
    kernels' launches, the all-reduce a step, the feed's waits and the
    card's busy share; the step's kernels timed on this rank's padded
    block and on a dummy block, each against its plain version; L2 the
    dense streamed LinearSVC; L3 the streamed KMeans (its k-means++ init
    drawn again here from the pooled reservoirs, for the parent's
    one-process fit); L4 FTRL and OnlineKMeans; L5 a rank-scoped snapshot.
    Returns the arrays the rank saves (``l_*``)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration import checkpoint as ckpt
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.iteration.stream_sync import (
        agree_max,
        pad_rows_to,
        pooled_sample,
    )
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models.kmeans import _kmeans_pp_init
    from flinkml_tpu_torch.utils.sampling import RowReservoir

    out, secs = {}, {}
    dicts, tuples = l_sparse(rank)
    budget = sum(a.nbytes for b in dicts for a in b.values()) // 2
    writer = DataCacheWriter(os.path.join(out_dir, f"l_cache{rank}"), budget)
    for b in dicts:
        writer.append(b)
    cache = writer.finish()

    def est(epochs, manager=None, resume=False):
        return (fml.LogisticRegression(
            mesh=mesh, checkpoint_manager=manager,
            checkpoint_interval=1 if manager else 0, resume=resume)
            .set_max_iter(epochs).set_tol(0.0).set_learning_rate(STREAM_LR)
            .set_reg(STREAM_REG))

    est(1).fit(cache)   # first fit: allocator, kernels and gloo warm
    fml.reset_launch_counts()
    with FeedWaits() as feed:
        secs["fit"], main = _seconds(torch, lambda: est(
            L_EPOCHS, CheckpointManager(os.path.join(out_dir, "l_ckpt"),
                                        max_to_keep=10)).fit(cache)
            .coefficient)
    main_counts = dict(fml.launch_counts())
    crash_dir = os.path.join(out_dir, "l_crash")
    # A scripted torn write of epoch L_CRASH + 1's commit, armed on both
    # ranks: the writer (rank 0) raises inside the write, the other rank
    # at the commit's agreement.
    with faults.armed(faults.FaultPlan(faults.TornWrite(L_CRASH + 1))) as plan:
        try:
            sgd.train_linear_model_stream(
                cache, "logistic", L_EPOCHS, STREAM_LR, STREAM_REG, 0.0, 0.0,
                checkpoint_manager=CheckpointManager(crash_dir,
                                                     max_to_keep=10),
                checkpoint_interval=1, sparse_dim=SPMV_DIM, mesh=mesh)
            crashed = 0
        except faults.FaultInjected as e:
            crashed = int("torn checkpoint write" in str(e))
        except ValueError as e:
            crashed = int("checkpoint commit" in str(e))
    latest = CheckpointManager(crash_dir).latest_epoch()
    torn_left = [name for name in os.listdir(crash_dir)
                 if name.startswith(".tmp") or name == f"ckpt-{L_CRASH + 1}"]
    secs["resume"], resumed = _seconds(torch, lambda: est(
        L_EPOCHS, CheckpointManager(crash_dir, max_to_keep=10),
        resume=True).fit(cache).coefficient)
    share = device_share(torch, lambda: est(1).fit(cache))
    counts = fml.launch_counts()
    ar_ms = all_reduce_ms(torch, mesh, SPMV_DIM + 2)
    out.update(l_main=main, l_resumed=resumed,
               l_crash=np.asarray([crashed, -1 if latest is None
                                   else latest]),
               l_torn=np.asarray([len(plan.log), len(torn_left)]),
               l_main_launches=np.asarray([main_counts.get("spmv", 0),
                                           main_counts.get("segment_sum", 0)]),
               l_launches=np.asarray([counts.get("spmv", 0),
                                      counts.get("segment_sum", 0)]),
               l_feed_waits=np.asarray(feed.waits),
               l_share=np.asarray([np.nan if share is None else share]),
               l_all_reduce_ms=np.asarray([ar_ms]),
               l_spilled=np.asarray([len(cache.segments)]))

    # L2: the dense streamed LinearSVC.
    dense = l_dense(rank)
    svc = (fml.LinearSVC(mesh=mesh).set_max_iter(L_EPOCHS).set_tol(0.0)
           .set_reg(SVC_REG).set_elastic_net(SVC_EN)
           .set_learning_rate(SVC_LR))
    secs["svc"], svc_coef = _seconds(torch, lambda: svc.fit(iter(
        fml.Table({"features": x, "label": yb}) for x, yb in dense))
        .coefficient)
    out["l_svc"] = svc_coef
    del dense

    # L3: the streamed KMeans with the k-means++ init from the pooled
    # reservoirs; the same draw again here, for the parent's check.
    blobs = l_blobs(rank)
    km = (fml.KMeans(mesh=mesh).set_k(L_KM_K).set_seed(0)
          .set_max_iter(L_KM_EPOCHS).set_init_mode("k-means++"))
    secs["kmeans"], cents = _seconds(torch, lambda: km.fit(iter(
        fml.Table({"features": x}) for x in blobs)).centroids)
    cap = max(L_KM_K, 65_536)
    reservoir = RowReservoir(cap, seed=0)
    for x in blobs:
        reservoir.add(x)
    pooled = pooled_sample(reservoir.sample(), sum(x.shape[0] for x in blobs),
                           cap, 0, mesh)
    out["l_km"] = cents
    out["l_km_init"] = _kmeans_pp_init(pooled, L_KM_K,
                                       np.random.default_rng(0)).astype(
        np.float32)
    del blobs, pooled, reservoir

    # L4: FTRL and OnlineKMeans.
    ftrl, okm, init = l_online(rank)
    secs["ftrl"], olr = _seconds(torch, lambda: (
        fml.OnlineLogisticRegression(mesh=mesh).set_alpha(FTRL_ALPHA)
        .set_beta(FTRL_BETA).set_reg(FTRL_REG).set_elastic_net(FTRL_EN)
        .fit_stream(iter(fml.Table({"features": x, "label": yb})
                         for x, yb in ftrl))))
    secs["online_kmeans"], ok = _seconds(torch, lambda: (
        fml.OnlineKMeans(mesh=mesh).set_k(OKM_K).set_decay_factor(OKM_DECAY)
        .set_initial_model_data(fml.Table({"centroids": init[None]}))
        .fit_stream(iter(fml.Table({"features": x}) for x in okm))))
    out.update(l_ftrl=olr.coefficient, l_okm=ok.centroids,
               l_versions=np.asarray([olr.model_version, ok.model_version]))
    del ftrl, okm

    # L5: a rank-scoped snapshot of the fitted coefficient (replicated)
    # and this rank's margins on its first batch (sharded:0).
    ip, idx, val, _, _ = tuples[0]
    margins = np.add.reduceat(val.astype(np.float64)
                              * main.astype(np.float64)[idx], ip[:-1])
    ckpt.save_agreed(
        ckpt.rank_scoped(CheckpointManager(os.path.join(out_dir, "l_family"),
                                           world_size=mesh.num_devices)),
        {"coef": main, "margins": margins}, L_EPOCHS, mesh, per_rank=True,
        layouts={"coef": "replicated", "margins": "sharded:0"})
    out["l_margins"] = margins

    # The step's kernels: this rank's first batch packed at the agreed
    # width and height, and a dummy block, each against its plain version
    # on every rank; timed beside its bound on the first rank alone, after
    # the others have finished with the card.
    height = max(L_ROWS)
    width = sgd._ell_width_for(SPMV_NNZ)
    bi, bv = sgd._pack_uniform_ell(*tuples[0][:3], np.float32, width=width)
    blocks = {"step": (pad_rows_to(bi, height), pad_rows_to(bv, height)),
              "dummy": (np.zeros((height, width), np.int32),
                        np.zeros((height, width), np.float32))}
    coef = torch.from_numpy(np.asarray(main, np.float32)).cuda()

    def calls(ib, vb, contrib, flat):
        """``{kernel: (kernel call, plain call)}`` on one block."""
        return {"spmv": (lambda: kspmv.spmv(ib, vb, coef),
                         lambda: kspmv.spmv_plain(ib, vb, coef)),
                "segment_sum": (
                    lambda: ksegsum.segment_sum(contrib, flat, SPMV_DIM),
                    lambda: ksegsum.segment_sum_plain(contrib, flat,
                                                      SPMV_DIM))}

    kernels, timed = [], []
    for label, (hb_i, hb_v) in blocks.items():
        ib, vb = (torch.from_numpy(a).cuda() for a in (hb_i, hb_v))
        flat = ib.reshape(-1)
        contrib = torch.randn(vb.numel(), device="cuda") * vb.reshape(-1)
        cells, pads = flat.numel(), int((vb == 0).sum())
        touched = int(torch.unique(flat).numel())
        work = {"spmv": (cells * 8 + touched * 4 + height * 4, 2.0 * cells),
                "segment_sum": (cells * 8 + SPMV_DIM * 4, cells)}
        for name, (fn, plain) in calls(ib, vb, contrib, flat).items():
            got, want = fn(), plain()
            bound, by = bound_ms(*work[name], "float32")
            kernels.append([["step", "dummy"].index(label),
                            ["spmv", "segment_sum"].index(name),
                            max_err(got, want),
                            float(torch.allclose(got.double(), want.double(),
                                                 rtol=1e-5, atol=1e-5)),
                            np.nan, np.nan, bound, float(by == "bytes"),
                            cells, pads])
            timed.append((fn, plain))
    torch.cuda.synchronize()
    agree_max(0, mesh)   # every rank is done with the card
    if rank == 0:
        timer = Timer(torch)
        for row, (fn, plain) in zip(kernels, timed):
            row[4], row[5] = timer(fn), timer(plain)
    out["l_kernels"] = np.asarray(kernels, np.float64)
    out["l_seconds"] = np.asarray([secs[k] for k in (
        "fit", "resume", "svc", "kmeans", "ftrl", "online_kmeans")])
    return out


def l_references():
    """Path L's references that need no rank's output: the float64 numpy
    runs of the combined-step streams (L1, L2, L4) and L3's combined
    batches. The parent makes them while the kernels build
    (:func:`prepare_references`), so that no rank is timed while they
    load the host."""
    online = [l_online(r) for r in range(J2_WORLD)]
    refs = {"L1": numpy_csr_stream_fit(
                l_csr_steps([l_sparse(r)[1] for r in range(J2_WORLD)]),
                SPMV_DIM, L_EPOCHS, STREAM_LR, STREAM_REG, 0.0),
            "L2": numpy_dense_stream_fit(
                l_combined([l_dense(r) for r in range(J2_WORLD)]), L_EPOCHS,
                SVC_LR, SVC_REG * (1 - SVC_EN), SVC_REG * SVC_EN, "hinge"),
            "L4_ftrl": numpy_ftrl(
                l_combined([f for f, _, _ in online]), FTRL_ALPHA, FTRL_BETA,
                FTRL_REG * FTRL_EN, FTRL_REG * (1.0 - FTRL_EN)),
            "L4_okm": numpy_online_kmeans(
                l_combined([k for _, k, _ in online]), online[0][2],
                OKM_DECAY)}
    del online
    refs["L3_batches"] = l_combined([l_blobs(r) for r in range(J2_WORLD)])
    return refs


def timed_refs():
    """``(l_references(), seconds)``."""
    t0 = time.perf_counter()
    refs = l_references()
    return refs, time.perf_counter() - t0


def l_check(torch, tmp, outs, refs):
    """Path L's checks in the parent, on J2's ranks' outputs: every fit
    the same bits on both ranks; L1 against a float64 numpy run of the
    combined-step stream (step t joins every rank's batch t) within 1e-5
    of the largest coefficient, the resumed fit within 1e-5 of the
    uninterrupted one, 18 launches of each kernel a rank in the main fit;
    L2 against float64 numpy within 1e-4 (path F's limit); L3 against the
    port's one-process fit over the combined stream from the same
    k-means++ init within 1e-5; L4 FTRL against float64 numpy within 1e-4
    (path G's), OnlineKMeans within 1e-5 (float32 sums) and both versions
    the most batches of a rank; L5 the rank-scoped family resharded to
    world 1 (``reshard_rank_state``); the step's kernels against their
    plain versions (rtol/atol 1e-5). ``refs`` is what
    :func:`l_references` returned. Returns ``(record, {kernel: launches
    summed over the ranks})``."""
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.checkpoint import reshard_rank_state
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream

    problems = []
    for name in [k for k in outs[0] if k.startswith("l_") and k not in (
            "l_feed_waits", "l_share", "l_all_reduce_ms", "l_spilled",
            "l_kernels", "l_seconds", "l_margins", "l_launches",
            "l_main_launches", "l_torn")]:
        if not np.array_equal(outs[1][name], outs[0][name]):
            problems.append(f"rank 1's {name} differs from rank 0's")
    o = outs[0]
    errs = {"L1_numpy": rel_err(o["l_main"], refs["L1"]),
            "L1_resumed": rel_err(o["l_resumed"],
                                  np.asarray(o["l_main"], np.float64)),
            "L2_numpy": rel_err(o["l_svc"], refs["L2"]),
            "L4_ftrl_numpy": rel_err(o["l_ftrl"], refs["L4_ftrl"]),
            "L4_okm_numpy": rel_err(o["l_okm"], refs["L4_okm"])}
    one = train_kmeans_stream(iter({"x": x} for x in refs["L3_batches"]),
                              k=L_KM_K, max_iter=L_KM_EPOCHS,
                              initial_centroids=o["l_km_init"])
    errs["L3_one_process"] = rel_err(o["l_km"], np.asarray(one, np.float64))
    del refs
    for what, limit in (("L1_numpy", 1e-5), ("L1_resumed", 1e-5),
                        ("L2_numpy", 1e-4), ("L3_one_process", 1e-5),
                        ("L4_ftrl_numpy", 1e-4), ("L4_okm_numpy", 1e-5)):
        if not np.isfinite(errs[what]) or errs[what] > limit:
            problems.append(f"{what} differs by {errs[what]} of the largest "
                            f"(limit {limit})")
    steps = max(L_BATCHES) * L_EPOCHS
    for r, out in enumerate(outs):
        if out["l_main_launches"].tolist() != [steps, steps]:
            problems.append(f"rank {r}: main fit launches "
                            f"{out['l_main_launches'].tolist()}, expected "
                            f"{steps} of each kernel")
        if out["l_crash"].tolist() != [1, L_CRASH]:
            problems.append(f"rank {r}: crash / newest snapshot "
                            f"{out['l_crash'].tolist()}")
        # The torn write fires where the snapshot is written (rank 0) and
        # leaves neither a committed nor a temporary directory behind.
        if out["l_torn"].tolist() != [int(r == 0), 0]:
            problems.append(f"rank {r}: TornWrite fired / torn directories "
                            f"left {out['l_torn'].tolist()}")
        for row in out["l_kernels"]:
            if row[3] != 1.0:
                problems.append(f"rank {r}: a step kernel differs from its "
                                f"plain version by {row[2]}")
    if o["l_versions"].tolist() != [L_ON_BATCHES, L_ON_BATCHES]:
        problems.append(f"online versions {o['l_versions'].tolist()}")
    if CheckpointManager(os.path.join(tmp, "l_ckpt")).all_epochs() != list(
            range(1, L_EPOCHS + 1)):
        problems.append("L1's shared snapshots are "
                        f"{CheckpointManager(os.path.join(tmp, 'l_ckpt')).all_epochs()}")
    family = reshard_rank_state(os.path.join(tmp, "l_family"), L_EPOCHS,
                                {"coef": 0, "margins": 0}, (0, 1))
    if not (np.array_equal(family["coef"], o["l_main"]) and np.array_equal(
            family["margins"], np.concatenate([out["l_margins"]
                                               for out in outs]))):
        problems.append("L5: the world-2 family resharded to world 1 "
                        "differs from the ranks' leaves")
    if problems:
        fail("path L: " + "; ".join(problems))
    launches = np.sum([out["l_launches"] for out in outs], axis=0)
    counts = {"spmv": int(launches[0]), "segment_sum": int(launches[1])}
    kern = {}
    for row in o["l_kernels"]:
        block = ["step", "dummy"][int(row[0])]
        name = ["spmv", "segment_sum"][int(row[1])]
        kern[f"{name}_{block}"] = {
            "ms": row[4], "plain_ms": row[5], "bound_ms": row[6],
            "bound_by": "bytes" if row[7] else "operations",
            "max_abs_err": row[2], "cells": int(row[8]),
            "padding_cells": int(row[9])}
    rows = sum(b * r for b, r in zip(L_BATCHES, L_ROWS))
    fit_s = float(o["l_seconds"][0])
    rec = {"path": "stream_mp_L", "world": J2_WORLD, "backend": J2_BACKEND,
           "batches": list(L_BATCHES), "batch_rows": list(L_ROWS),
           "dim": SPMV_DIM, "nnz": SPMV_NNZ, "epochs": L_EPOCHS,
           "spilled_batches": [int(out["l_spilled"][0]) for out in outs],
           "L1_fit_s": fit_s, "L1_samples_per_s": rows * L_EPOCHS / fit_s,
           "L1_resume_s": float(o["l_seconds"][1]),
           "L1_torn_write_fired_left": [out["l_torn"].tolist()
                                        for out in outs],
           "all_reduce_ms_per_step": [float(out["l_all_reduce_ms"][0])
                                      for out in outs],
           "steps_per_epoch": max(L_BATCHES),
           "feed_wait_s_per_epoch": [out["l_feed_waits"].tolist()
                                     for out in outs],
           "device_share": [None if np.isnan(out["l_share"][0])
                            else float(out["l_share"][0]) for out in outs],
           "kernels_rank0": kern,
           "seconds_rank0": dict(zip(("L1_fit", "L1_resume", "L2_svc",
                                      "L3_kmeans", "L4_ftrl",
                                      "L4_online_kmeans"),
                                     o["l_seconds"].tolist())),
           "rel_err": errs, "launches": counts,
           "launches_main_fit_per_rank": [out["l_main_launches"].tolist()
                                          for out in outs]}
    return rec, counts


def mesh_world2(torch, refs, x, y):
    """J2: :func:`j2_rank` on ``J2_WORLD`` ranks spawned here, all on the
    one card, within one deadline (a rank that fails or hangs, or a gloo
    collective that refuses CUDA tensors, fails the run). The ranks' fits
    must agree bit for bit and hold against the float64 numpy run of the
    two-shard step (1e-4 of the largest coefficient); ``keyed_aggregate``
    against ``segment_sum_plain`` of each shard on the card, summed (1e-5
    of the largest sum: float32 atomics in both). The ranks also run path
    K2 (:func:`k2_rank`), checked here by :func:`k2_check` while their
    directory lives, and path L (:func:`l_rank`), checked by
    :func:`l_check`. Returns ``(record, {kernel: launches summed over the
    ranks}, K2's record, (L's record, L's launches))``."""
    import tempfile

    from flinkml_tpu_torch.kernels.segsum import segment_sum_plain
    from flinkml_tpu_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks([sys.executable, os.path.abspath(__file__),
                             "--j2-rank", tmp], J2_WORLD, tmp, J2_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(J2_WORLD)]
        k2 = k2_check(torch, tmp, outs, x, y)
        l_refs, refs_s = PREPARED.pop("l_refs", None) or timed_refs()
        l_rec, l_counts = l_check(torch, tmp, outs, l_refs)
        l_rec["references_s"] = refs_s
    for r, res in enumerate(ranks):
        log(f"path J2 rank {r}: exit {res.returncode}")
    for name in ("sparse", "dense", "keyed"):
        for r in range(1, J2_WORLD):
            if not np.array_equal(outs[r][name], outs[0][name]):
                fail(f"path J2: rank {r}'s {name} differs from rank 0's by "
                     f"{float(np.abs(outs[r][name] - outs[0][name]).max())}")
    rec = {"world": J2_WORLD, "backend": J2_BACKEND, "wall_s": wall_s,
           "ranks_bit_for_bit": True,
           "devices": [int(o["device"][0]) for o in outs],
           "seconds_rank0": dict(zip(("sparse_fit", "dense_fit", "keyed"),
                                     outs[0]["seconds"].tolist())),
           "all_reduce_ms_per_step": [float(o["all_reduce_ms"][0])
                                      for o in outs],
           "max_abs_err_vs_float64": {}}
    for name, ref in (("sparse", refs["sparse"]), ("dense", refs["dense2"])):
        err = float(np.abs(outs[0][name] - ref).max())
        rec["max_abs_err_vs_float64"][name] = err
        if not err <= 1e-4 * np.abs(ref).max():
            fail(f"path J2: the {name} fit differs from the float64 two-shard "
                 f"step by {err}")
    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=0)
    half = values.size // J2_WORLD
    want = sum(segment_sum_plain(
        torch.from_numpy(values[r * half:(r + 1) * half]).to(J_DEVICE),
        torch.from_numpy(indices[r * half:(r + 1) * half]).to(J_DEVICE),
        SPMV_DIM) for r in range(J2_WORLD)).cpu().numpy()
    err = float(np.abs(outs[0]["keyed"] - want).max())
    rec["keyed_max_abs_err"] = err
    if not err <= 1e-5 * np.abs(want).max():
        fail(f"path J2: keyed_aggregate differs from segment_sum_plain by {err}")
    step_s = outs[0]["seconds"][0] / J_EPOCHS
    rec["all_reduce_share_of_sparse_step"] = \
        float(outs[0]["all_reduce_ms"][0]) / 1e3 / step_s
    launches = np.sum([o["launches"] for o in outs], axis=0)
    return rec, {"spmv": int(launches[0]),
                 "segment_sum": int(launches[1])}, k2, (l_rec, l_counts)


def mesh_inputs():
    """Path J's inputs and float64 references: ``(data, refs, seconds)``."""
    t0 = time.perf_counter()
    data = mesh_data()
    indptr, indices, values, y, w = data["csr"]
    x, yd, wd = data["dense"]
    refs = {"sparse": numpy_sparse_fit(indptr, indices, values, SPMV_DIM, y,
                                       w, J_EPOCHS, FIT_LR),
            "dense1": numpy_dense_fit(x, yd, wd, 0, FIT_BATCH, J_EPOCHS,
                                      FIT_LR),
            "dense2": numpy_dense_fit(x, yd, wd, 0, FIT_BATCH, J_EPOCHS,
                                      FIT_LR, p=J2_WORLD)}
    return data, refs, time.perf_counter() - t0


def mesh_path(torch):
    """Path J: ``parallel/`` on ``torch.distributed``: J1 (world 1 over
    nccl, the fits with and without a mesh) and J2 (two ranks on the one
    card over gloo), at path B's sparse width and path 5's dense width.
    The J2 ranks also run paths K2 (:func:`k2_rank`) and L (the streamed
    fits on several ranks, :func:`l_rank`). Returns the launches of
    ``spmv`` and ``segment_sum`` in J1 and in every rank of J2, K2's
    record and path L's launches; fails when either kernel never launched
    in J or in L."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    data, refs, ref_s = PREPARED.pop("mesh", None) or mesh_inputs()
    x, yd, _ = data["dense"]
    fml.reset_launch_counts()
    plain = mesh_fits(torch, None, data)
    j1 = mesh_world1(torch, data, plain, refs)
    del data
    counts = dict(fml.launch_counts())
    j2, j2_counts, k2, (l_rec, l_counts) = mesh_world2(torch, refs, x, yd)
    for name, n in j2_counts.items():
        counts[name] = counts.get(name, 0) + n
    missing = [k for k in ("spmv", "segment_sum") if not counts.get(k)]
    if missing:
        fail(f"path J: {missing} never launched ({counts})")
    rec = {"path": "mesh_J", "rows": SPARSE_FIT_ROWS, "dim": SPMV_DIM,
           "nnz": SPMV_NNZ, "dense_rows": DENSE_FIT_ROWS,
           "dense_d": DENSE_FIT_D, "epochs": J_EPOCHS, "batch": FIT_BATCH,
           "kmeans": [MESH_KMEANS_N, MESH_KMEANS_D, MESH_KMEANS_K,
                      MESH_KMEANS_ITERS],
           "J1": j1, "J2": j2, "numpy_refs_s": ref_s,
           "launches": {k: counts.get(k, 0) for k in ("spmv", "segment_sum")},
           "J2_launches": j2_counts, "card": card_line(),
           "path_s": time.perf_counter() - t0}
    log("path " + json.dumps(rec))
    missing = [k for k in ("spmv", "segment_sum") if not l_counts.get(k)]
    if missing:
        fail(f"path L: {missing} never launched ({l_counts})")
    l_rec["card"] = card_line()
    log("path " + json.dumps(l_rec))
    return counts, k2, l_counts


# -- path K: sharding plans, mixed precision, NaiveBayes and the graph API -----

#: Path K's device (the rehearsal on the CPU sets "cpu").
K_DEVICE = "cuda"
#: K1/K2's elastic net (the soft threshold runs every step) and K2's stop.
K_REG, K_ELASTIC_NET, K2_STOP = 2e-4, 0.5, 6  # 10 until path U
K_PLANS = ("batch_parallel", "fsdp", "fsdp_tp")
#: K3: NaiveBayes rows (fit) and transform rows; the graph's census rows.
NB_ROWS, NB_SERVE = 2_000_000, 1_000_000
NB_CONTINUOUS = ("age", "education_num", "hours_per_week")


def k_kw(**over):
    """The plan fits' hyperparameters: path 5's batch, epochs and rate,
    momentum 0.9, ``K_REG`` split by ``K_ELASTIC_NET``."""
    kw = dict(max_iter=FIT_EPOCHS, learning_rate=FIT_LR, momentum=0.9,
              global_batch_size=FIT_BATCH, reg=K_REG,
              elastic_net=K_ELASTIC_NET)
    kw.update(over)
    return kw


def bf16_round(a):
    """float32 values rounded to bfloat16 (nearest, ties to even, on the
    float32 bits), returned as float32: the card's rounding, without
    ``ml_dtypes``."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    # No finite value overflows 32 bits here (the largest, 0xFF7FFFFF,
    # plus 0x8000 stays below 2^32).
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def f16_round(a):
    """float32 values rounded to float16 (nearest, ties to even), returned
    as float32."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def numpy_plan_windows(x, y, seed, batch):
    """The plan trainer's windows after the estimator's seeded shuffle:
    clamped, rotating with the epoch; each ``(x float64, y, w, x as
    given)``. Padding to a world's rows adds rows of weight 0, which add
    nothing, and each rank's block is a slice of the window, so the
    step's sums are the window's at every world."""
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    bs = min(batch, n)
    out = []
    for widx in range(max(-(-n // bs), 1)):
        start = min(widx * bs, max(n - bs, 0))
        rows = perm[start:start + bs]
        out.append((x[rows].astype(np.float64), y[rows].astype(np.float64),
                    np.ones(rows.size), x[rows]))
    return out


def numpy_plan_fit(windows, optimizer, epochs, lr, momentum, l2, l1,
                   mixed=False):
    """Float64 numpy run of ``train_linear_plan``'s steps (logistic loss):
    momentum SGD or Adam, the L1 soft threshold. ``mixed`` emulates a
    policy that narrows compute: the batch, ``coef`` and the margin
    multiplier rounded (through float32) before the products, to bfloat16
    (``True``, the ``mixed`` policy) or by the function given (float16:
    :func:`f16_round`)."""
    rnd = bf16_round if mixed is True else mixed
    mixed = bool(mixed)
    d = windows[0][0].shape[1]
    coef, buf = np.zeros(d), np.zeros(d)
    m, v, t = np.zeros(d), np.zeros(d), 0.0
    xs = [rnd(x32).astype(np.float64) if mixed else x64
          for x64, _, _, x32 in windows]
    for ep in range(epochs):
        _, yb, wb, _ = windows[ep % len(windows)]
        xb = xs[ep % len(windows)]
        c = rnd(coef.astype(np.float32)).astype(np.float64) \
            if mixed else coef
        ys = 2.0 * yb - 1.0
        mult = wb * (-ys / (1.0 + np.exp(xb @ c * ys)))
        if mixed:
            mult = rnd(mult.astype(np.float32)).astype(np.float64)
        wsum = max(wb.sum(), 1e-12)
        grad = xb.T @ mult / wsum + 2.0 * l2 * coef
        if optimizer == "sgd":
            buf = momentum * buf + grad
            step = buf
        else:
            t += 1.0
            m = 0.9 * m + 0.1 * grad
            v = 0.999 * v + 0.001 * grad * grad
            step = (m / (1.0 - 0.9 ** t)) / (
                np.sqrt(v / (1.0 - 0.999 ** t)) + 1e-8)
        x = coef - lr * step
        coef = np.sign(x) * np.maximum(np.abs(x) - lr * l1, 0.0)
    return coef


def plan_collective_ms(torch, plan, mesh, dim, calls=20):
    """Host-clock milliseconds of the plan step's all-gather of ``coef``
    and its all-reduce of ``[grad | loss_sum | wsum]`` (float32),
    synchronized, the mean of ``calls`` after 3 warm-up calls."""
    from flinkml_tpu_torch.sharding.apply import _PlanSync

    sync = _PlanSync(plan, mesh, dim)
    block = torch.ones(sync.block, dtype=torch.float32, device=mesh.device)
    buf = torch.ones(dim + 2, dtype=torch.float32, device=mesh.device)
    out = {}
    for name, fn in (("all_gather", lambda: sync.gather(block)),
                     ("all_reduce", lambda: sync.reduce(buf))):
        for _ in range(3):
            fn()
        secs, _ = _seconds(torch, lambda: [fn() for _ in range(calls)])
        out[name + "_ms"] = secs / calls * 1e3
    return out


def plan_world1(torch, x, y, refs):
    """K1: ``init_distributed`` at world 1 over ``J1_BACKEND`` (nccl), then
    ``LogisticRegression(sharding_plan=...)`` (momentum SGD) and
    ``train_linear_plan`` (Adam) under each of ``K_PLANS`` on path 5's
    data, every fit on the plan's mesh of the one rank: the plans equal
    each other bit for bit (at world 1 each collective is the identity)
    and hold against the float64 numpy steps (1e-4 of the largest
    coefficient); ``precision="mixed"`` against the numpy emulation of its
    bf16 rounding (1e-3 of the largest) and against the float32 fit
    (different, within 2e-2); ``dtype=bfloat16`` (FML601) and float64
    (FML605) under ``mixed`` refused before any step or collective."""
    import tempfile

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.parallel import DeviceMesh, dispatch
    from flinkml_tpu_torch.parallel import distributed as pdist
    from flinkml_tpu_torch.precision import PrecisionValidationError
    from flinkml_tpu_torch.sharding import PRESETS, apply, train_linear_plan

    table = fml.Table({"features": x, "label": y})
    n = x.shape[0]
    perm = np.random.default_rng(0).permutation(n)
    xp, yp = x[perm], y[perm]

    def est(**kw):
        return (fml.LogisticRegression(**kw).set_seed(0).set_tol(0.0)
                .set_global_batch_size(FIT_BATCH).set_max_iter(FIT_EPOCHS)
                .set_learning_rate(FIT_LR).set_reg(K_REG))

    rec = {"backend": J1_BACKEND, "fits": {}}
    with tempfile.TemporaryDirectory() as tmp:
        pdist.init_distributed("file://" + os.path.join(tmp, "store"), 1, 0,
                               backend=J1_BACKEND, timeout_s=300)
        try:
            # The no-plan fit of path 5 (same data and hyperparameters but
            # the elastic net: LogisticRegression has none), the ratio's
            # denominator.
            est().fit(table)
            no_plan_s, _ = _seconds(torch, lambda: est().fit(table))
            coefs = {}
            for name in K_PLANS:
                plan = PRESETS[name]
                mesh = DeviceMesh.for_plan(plan)
                # Momentum SGD through the estimator (its seeded
                # permutation is xp's), Adam through train_linear_plan.
                secs, model = _seconds(torch, lambda: est(
                    sharding_plan=plan).fit(table))
                coefs[name, "sgd"] = model.coefficient
                rec["fits"][f"{name}/sgd"] = {
                    "fit_s": secs,
                    "samples_per_s": FIT_BATCH * FIT_EPOCHS / secs,
                    "ratio_to_no_plan_fit": secs / no_plan_s}
                stats = {}
                secs, coefs[name, "adam"] = _seconds(
                    torch, lambda: train_linear_plan(
                        xp, yp, None, plan, mesh, optimizer="adam",
                        stats=stats, **k_kw()))
                steps = max(stats["steps"], 1)
                rec["fits"][f"{name}/adam"] = {
                    "fit_s": secs, "loop_s": stats["loop_s"],
                    "samples_per_s": FIT_BATCH * FIT_EPOCHS / secs,
                    "loop_samples_per_s":
                        FIT_BATCH * FIT_EPOCHS / stats["loop_s"],
                    "all_gather_per_step":
                        stats["collectives"]["all_gather"] / steps,
                    "all_reduce_per_step":
                        stats["collectives"]["all_reduce"] / steps,
                    "ratio_to_no_plan_fit": secs / no_plan_s}
                rec["fits"][f"{name}/collective_ms"] = plan_collective_ms(
                    torch, plan, mesh, x.shape[1])
            mesh = DeviceMesh.for_plan(PRESETS["fsdp"])
            secs, mixed = _seconds(torch, lambda: train_linear_plan(
                xp, yp, None, PRESETS["fsdp"], mesh, precision="mixed",
                **k_kw()))
            rec["fits"]["fsdp/sgd/mixed"] = {
                "fit_s": secs, "samples_per_s": FIT_BATCH * FIT_EPOCHS / secs}
            full = train_linear_plan(xp, yp, None, PRESETS["fsdp"], mesh,
                                     **k_kw())
            events, calls = [], []
            real_call = apply.LinearStep.__call__
            apply.LinearStep.__call__ = (
                lambda self, *a, **k: (calls.append(1),
                                       real_call(self, *a, **k))[1])
            dispatch.add_dispatch_observer(events.append)
            refused = {}
            try:
                for dtype, rule in (("bfloat16", "FML601"),
                                    (np.float64, "FML605")):
                    try:
                        train_linear_plan(xp, yp, None, PRESETS["fsdp"], mesh,
                                          dtype=dtype, precision="mixed",
                                          **k_kw())
                        fail(f"path K1: dtype={dtype} under mixed was "
                             "not refused")
                    except PrecisionValidationError as e:
                        rules = sorted({f.rule for f in e.findings})
                        if rule not in rules:
                            fail(f"path K1: dtype={dtype} refused with "
                                 f"{rules}, not {rule}")
                        refused[str(np.dtype(dtype)) if dtype != "bfloat16"
                                else dtype] = rules
            finally:
                apply.LinearStep.__call__ = real_call
                dispatch.remove_dispatch_observer(events.append)
            if events or calls:
                fail(f"path K1: a refused fit ran {len(calls)} steps and "
                     f"{len(events)} collectives")
            rec["refused"] = refused
        finally:
            pdist.shutdown_distributed()
    rec["no_plan_fit_s"] = no_plan_s
    ref_max = {k: float(np.abs(v).max()) for k, v in refs.items()}
    for (name, opt), got in coefs.items():
        if not np.array_equal(got, coefs[K_PLANS[0], opt]):
            fail(f"path K1: {name}/{opt} differs from {K_PLANS[0]}/{opt} "
                 "at world 1")
        want = refs["sgd_l1_0" if opt == "sgd" else "adam"]
        err = float(np.abs(got - want).max())
        rec["fits"][f"{name}/{opt}"]["max_abs_err_vs_float64"] = err
        if not (np.isfinite(got).all() and err <= 1e-4 * np.abs(want).max()):
            fail(f"path K1: {name}/{opt} differs from float64 numpy by {err}")
    err = float(np.abs(mixed - refs["mixed"]).max())
    gap = float(np.abs(mixed - full).max())
    rec["mixed"] = {"max_abs_err_vs_bf16_emulation": err,
                    "max_abs_diff_vs_float32": gap,
                    "max_abs_coef": ref_max["mixed"]}
    if not err <= 1e-3 * ref_max["mixed"]:
        fail(f"path K1: the mixed fit differs from its numpy emulation by {err}")
    if not 0.0 < gap <= 2e-2:
        fail(f"path K1: the mixed fit is {gap} from the float32 fit")
    return rec


def naive_bayes_data(n, seed):
    """K3's rows: Adult's 8 categorical columns (``census_columns``) and
    age, education-num and hours-per-week as integer categories."""
    cols = census_columns(n, seed)
    names = [c for c, _ in ADULT_CATEGORICAL] + list(NB_CONTINUOUS)
    x = np.stack([np.asarray(cols[c], dtype=np.float64) for c in names], 1)
    return x, cols["label"]


def numpy_naive_bayes(x, y, smoothing=1.0):
    """Float64 numpy NaiveBayes: the vocabularies, the counts by
    ``np.add.at``, theta and pi by the reference's formula."""
    labels, li = np.unique(y, return_inverse=True)
    vocab, ci = zip(*(np.unique(x[:, j], return_inverse=True)
                      for j in range(x.shape[1])))
    L, F, C = len(labels), x.shape[1], max(len(v) for v in vocab)
    flat = (li[:, None] * (F * C) + np.arange(F)[None, :] * C
            + np.stack(ci, 1)).reshape(-1)
    counts = np.zeros(L * F * C)
    np.add.at(counts, flat, 1.0)
    counts = counts.reshape(L, F, C)
    docs = np.bincount(li, minlength=L).astype(np.float64)
    ncat = np.array([len(v) for v in vocab], dtype=np.float64)
    theta = np.log(counts + smoothing) - np.log(
        docs[:, None] + smoothing * ncat[None, :])[:, :, None]
    for j in range(F):
        theta[:, j, len(vocab[j]):] = -np.inf
    pi = np.log(docs * F + smoothing) - np.log(docs.sum() * F
                                               + L * smoothing)
    return counts, theta, pi, labels, vocab, flat


def naive_bayes_phase(torch):
    """K3a: ``NaiveBayes().fit`` on ``NB_ROWS`` rows (11 features, 22 M
    cells counted by one ``segment_sum`` launch), counts, theta and pi
    equal to float64 numpy bit for bit; the transform of ``NB_SERVE``
    rows equal to the numpy argmax. Returns the record and the count's
    cells (for :func:`naive_bayes_kernel_check`)."""
    import flinkml_tpu_torch as fml

    x, y = naive_bayes_data(NB_ROWS, seed=31)
    table = fml.Table({"features": x, "label": y})
    before = fml.launch_counts()["segment_sum"]
    fit_s, model = _seconds(torch, lambda: fml.NaiveBayes().fit(table))
    fit_launches = fml.launch_counts()["segment_sum"] - before
    counts, theta, pi, labels, vocab, flat = numpy_naive_bayes(x, y)
    if not (np.array_equal(model._theta, theta)
            and np.array_equal(model._pi, pi)
            and np.array_equal(model._labels, labels)):
        fail("path K3: NaiveBayes theta/pi differ from float64 numpy")
    serve = x[:NB_SERVE]
    ts, (out,) = _seconds(torch, lambda: model.transform(
        fml.Table({"features": serve})))
    idx = np.stack([np.searchsorted(vocab[j], serve[:, j])
                    for j in range(x.shape[1])], 1)
    probs = pi[None, :] + sum(theta[:, j, idx[:, j]].T
                              for j in range(x.shape[1]))
    want = labels[np.argmax(probs, axis=1)]
    if not np.array_equal(out.column("prediction"), want):
        fail("path K3: NaiveBayes predictions differ from the numpy argmax")
    return {"rows": NB_ROWS, "features": x.shape[1], "cells": flat.size,
            "segments": counts.size, "fit_s": fit_s,
            "fit_rows_per_s": NB_ROWS / fit_s,
            "fit_segment_sum_launches": fit_launches,
            "transform_rows": NB_SERVE, "transform_s": ts,
            "transform_rows_per_s": NB_SERVE / ts}, (flat, counts)


def naive_bayes_kernel_check(torch, timer, flat, counts):
    """The count's ``segment_sum`` (float64 ones by the fit's flat ids)
    against ``segment_sum_plain`` on the same cells, bit for bit and equal
    to ``np.add.at``; timed beside ``index_add_``, with its bound from
    bytes (each cell's value and id read once, the counts written once).
    These launches are not the path's."""
    from flinkml_tpu_torch.kernels import segsum

    L, F, C = counts.shape
    ids = torch.from_numpy(flat.astype(np.int32)).to(K_DEVICE)
    ones = torch.ones(ids.numel(), dtype=torch.float64, device=K_DEVICE)
    got = segsum.segment_sum(ones, ids, L * F * C)
    plain = segsum.segment_sum_plain(ones, ids, L * F * C)
    if not torch.equal(got, plain) or not np.array_equal(
            got.cpu().numpy().reshape(L, F, C), counts):
        fail("path K3: segment_sum of the counts differs from its plain "
             "version or from np.add.at")
    ms = timer(lambda: segsum.segment_sum(ones, ids, L * F * C))
    plain_ms = timer(lambda: segsum.segment_sum_plain(ones, ids, L * F * C))
    lib = torch.zeros(L * F * C, dtype=torch.float64, device=K_DEVICE)
    library_ms = timer(lambda: lib.index_add_(0, ids, ones))
    cells = ids.numel()
    bound, by = bound_ms(cells * (8 + 4) + L * F * C * 8,
                         cells, "float64")
    return {"cells": cells, "segments": L * F * C, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0}


def graph_phase(torch):
    """K3b: a ``GraphBuilder`` graph of StandardScaler -> LogisticRegression
    on the census training rows (Adult's 14 columns as one float64
    vector), fit -> transform -> save -> load -> transform, equal to the
    same stages as a ``Pipeline`` (scaled 1e-12, rawPrediction 1e-10,
    predictions where decisive) and to itself after the round trip."""
    import tempfile

    import flinkml_tpu_torch as fml

    cols = census_columns(CENSUS_TRAIN, seed=21)
    names = [c for c, _ in ADULT_CATEGORICAL] + list(ADULT_CONTINUOUS)
    x = np.stack([np.asarray(cols[c], dtype=np.float64) for c in names], 1)
    table = fml.Table({"features": x, "label": cols["label"]})

    def stages():
        return (fml.StandardScaler().set_input_col("features")
                .set_output_col("scaled"),
                fml.LogisticRegression().set_features_col("scaled")
                .set_seed(0).set_global_batch_size(8_192)
                .set_max_iter(FIT_EPOCHS).set_learning_rate(0.5))

    b = fml.GraphBuilder()
    src = b.create_table_id()
    scaler, lr = stages()
    scaled = b.add_estimator(scaler, src)
    out = b.add_estimator(lr, scaled[0])
    graph = b.build_estimator([src], [out[0]])
    fit_s, gm = _seconds(torch, lambda: graph.fit(table))
    cols_out = ("scaled", "rawPrediction", "prediction")
    (g,) = gm.transform(table)
    (p,) = fml.Pipeline(list(stages())).fit(table).transform(table)
    with tempfile.TemporaryDirectory() as tmp:
        gm.save(os.path.join(tmp, "gm"))
        (again,) = fml.GraphModel.load(os.path.join(tmp, "gm")).transform(
            table)
    for c in cols_out:
        if not np.array_equal(again.column(c), g.column(c)):
            fail(f"path K3: the graph's {c} changed across save -> load")
    raw_g, raw_p = g.column("rawPrediction"), p.column("rawPrediction")
    if not (np.allclose(g.column("scaled"), p.column("scaled"), rtol=1e-12,
                        atol=1e-12)
            and np.allclose(raw_g, raw_p, rtol=1e-10, atol=1e-10)):
        fail("path K3: the graph's output differs from the Pipeline's")
    decisive = np.abs(raw_p[:, 1] - 0.5) > 1e-9
    if not np.array_equal(g.column("prediction")[decisive],
                          p.column("prediction")[decisive]):
        fail("path K3: the graph's predictions differ from the Pipeline's")
    return {"rows": CENSUS_TRAIN, "d": x.shape[1], "fit_s": fit_s,
            "max_abs_raw_diff_vs_pipeline": float(np.abs(raw_g - raw_p).max())}


def k2_check(torch, tmp, outs, x, y):
    """K2's checks in the parent, on the two ranks' outputs of
    :func:`j2_rank`: the FSDP and FSDP_TP fits the same bits on both
    ranks and within 1e-4 of the largest coefficient of the float64 numpy
    steps; the 123-wide fit refused (FML502) on both ranks; the world-2
    FSDP snapshot of epoch ``K2_STOP`` resumed at world 1 under
    ``rescale="reshard"``: at epoch ``K2_STOP`` the same bits, and carried
    on to ``FIT_EPOCHS`` within 1e-5 of the largest coefficient of the
    uninterrupted world-2 fit (float32 sums in another order)."""
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.sharding import FSDP, train_linear_plan

    for name in ("k2_fsdp", "k2_fsdp_tp", "k2_half", "k2_refused",
                 "k2_preempted"):
        if not np.array_equal(outs[1][name], outs[0][name]):
            fail(f"path K2: rank 1's {name} differs from rank 0's")
    if outs[0]["k2_preempted"].tolist() != [1, K2_STOP, 1]:
        fail(f"path K2: the RankLost stop gave "
             f"{outs[0]['k2_preempted'].tolist()}")
    if outs[0]["k2_elastic"].tolist() != [K2_STOP, J2_WORLD, 1]:
        fail(f"path K2: plan_elastic_resume on rank 0 gave "
             f"{outs[0]['k2_elastic'].tolist()}")
    if outs[0]["k2_refused"].tolist() != [1]:
        fail("path K2: FSDP over 123 columns at world 2 was not refused "
             "with FML502")
    xk = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], 1)
    windows = numpy_plan_windows(xk, y, 0, FIT_BATCH)
    ref = numpy_plan_fit(windows, "sgd", FIT_EPOCHS, FIT_LR, 0.9,
                         K_REG * (1 - K_ELASTIC_NET), K_REG * K_ELASTIC_NET)
    rec = {"world": J2_WORLD, "d": xk.shape[1],
           "rank_lost_stop": outs[0]["k2_preempted"].tolist(),
           "elastic_plan": outs[0]["k2_elastic"].tolist(),
           "seconds_rank0": dict(zip(("fsdp", "fsdp_tp", "fsdp_half"),
                                     outs[0]["k2_seconds"].tolist())),
           "collectives_per_step_fsdp": outs[0]["k2_collectives"].tolist()}
    for name in ("k2_fsdp", "k2_fsdp_tp"):
        err = float(np.abs(outs[0][name] - ref).max())
        rec[f"{name}_max_abs_err_vs_float64"] = err
        if not err <= 1e-4 * np.abs(ref).max():
            fail(f"path K2: {name} differs from float64 numpy by {err}")
    perm = np.random.default_rng(0).permutation(xk.shape[0])
    xp, yp = xk[perm], y[perm]
    ckpt = os.path.join(tmp, "k2_ckpt")
    kw = k_kw(checkpoint_interval=K2_STOP // 2, resume=True)
    with open(os.path.join(ckpt, f"ckpt-{K2_STOP}", "meta.json")) as fh:
        meta = json.load(fh)
    if meta["world_size"] != J2_WORLD or meta["layouts"] != [
            "sharded:0", "sharded:0"]:
        fail(f"path K2: the snapshot records {meta['world_size']}, "
             f"{meta['layouts']}")
    at_stop = train_linear_plan(
        xp, yp, None, FSDP, None, checkpoint_manager=CheckpointManager(
            ckpt, max_to_keep=10, rescale="reshard"),
        **dict(kw, max_iter=K2_STOP))
    if not np.array_equal(at_stop, outs[0]["k2_half"]):
        fail("path K2: the world-2 snapshot restored at world 1 differs")
    resumed = train_linear_plan(
        xp, yp, None, FSDP, None, checkpoint_manager=CheckpointManager(
            ckpt, max_to_keep=10, rescale="reshard"), **kw)
    err = float(np.abs(resumed - outs[0]["k2_fsdp"]).max())
    rec["resumed_at_world_1_max_abs_diff"] = err
    if not err <= 1e-5 * np.abs(ref).max():
        fail(f"path K2: the fit resumed at world 1 differs from the "
             f"uninterrupted world-2 fit by {err}")
    return rec


def plan_path(torch, timer, k2):
    """Path K: K1 (the plan fits and the mixed-precision fit at world 1
    over nccl, :func:`plan_world1`), K2 (its record from path J's ranks,
    :func:`k2_check`), K3 (NaiveBayes and the graph API), the counters
    read after K3's graph; then the count's ``segment_sum`` against its
    plain version. Returns the path's launches and that check's record;
    fails when ``segment_sum`` never launched."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    x, y, _ = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
    windows = numpy_plan_windows(x, y, 0, FIT_BATCH)
    l2, l1 = K_REG * (1 - K_ELASTIC_NET), K_REG * K_ELASTIC_NET
    refs = {"sgd_l1_0": numpy_plan_fit(windows, "sgd", FIT_EPOCHS, FIT_LR,
                                       0.9, K_REG, 0.0),
            "adam": numpy_plan_fit(windows, "adam", FIT_EPOCHS, FIT_LR,
                                   0.9, l2, l1),
            "mixed": numpy_plan_fit(windows, "sgd", FIT_EPOCHS, FIT_LR, 0.9,
                                    l2, l1, mixed=True)}
    del windows
    ref_s = time.perf_counter() - t0
    fml.reset_launch_counts()
    k1 = plan_world1(torch, x, y, refs)
    del x, y
    nb, (flat, nb_counts) = naive_bayes_phase(torch)
    graph = graph_phase(torch)
    counts = dict(fml.launch_counts())
    if not counts.get("segment_sum"):
        fail(f"path K: segment_sum never launched ({counts})")
    nb["segment_sum"] = naive_bayes_kernel_check(torch, timer, flat,
                                                 nb_counts)
    del flat
    rec = {"path": "plan_K", "rows": DENSE_FIT_ROWS, "d": DENSE_FIT_D,
           "batch": FIT_BATCH, "epochs": FIT_EPOCHS, "reg": K_REG,
           "elastic_net": K_ELASTIC_NET, "K1": k1, "K2": k2,
           "K3": {"naive_bayes": nb, "graph": graph},
           "numpy_refs_s": ref_s,
           "launches": {k: counts.get(k, 0)
                        for k in ("segment_sum", "fused_chain")},
           "card": card_line(), "path_s": time.perf_counter() - t0}
    log("path " + json.dumps(rec))
    return counts, nb["segment_sum"]


# -- path M: fault injection, the numerics sentinel and recovery (item 12) -------------

#: M1: FTRL at path G's shape (64 x 16,384 x 123 float32), a snapshot every
#: M1_INTERVAL batches; two PoisonBatch, a NaNGrad and a CorruptSnapshot of
#: the NaNGrad's rollback target (the first commit at or after M1_CORRUPT).
M1_INTERVAL, M1_POISON, M1_NAN, M1_CORRUPT = 8, (10, 40), 25, 24
#: M1's timed fits: each repeat runs no sentinel, interval 1 and interval 8
#: back to back, in an order rotated each repeat; the verdict alone is
#: traced over M1_CHECKS calls.
M1_REPEATS, M1_CHECKS = 3, 250  # 6, 500 until path U
#: M2: OnlineKMeans at path I3's width (16 x 16,384 x 784, k = 10).
M2_BATCHES, M2_NAN = 16, 5
#: M3: path E's Criteo profile as a Dataset of SparseVector rows (4 batches
#: of 65,536: path E's 16 cut to a quarter), 3 epochs, a snapshot every
#: epoch, the epoch-0 cache at half the CSR bytes.
M3_BATCHES, M3_EPOCHS, M3_KILL, M3_DELAY_S = 4, 3, 2, 0.05
#: The seams' gate: fits under a plan that injects nothing (every seam
#: calls the plan) keep this share of the disarmed fits' mean samples/s,
#: timed in the order disarmed, armed, armed, disarmed, SEAM_ROUNDS times
#: (the order cancels a steady drift of the host). Path E's samples/s
#: spread 0.48-0.69 M across runs (a ratio of 0.70).
SEAM_FLOOR, SEAM_ROUNDS = 0.9, 2


def seam_abba(torch, fit, samples):
    """``fit()`` timed disarmed, under a plan that injects nothing, again
    under it and disarmed again, ``SEAM_ROUNDS`` times: the armed runs pay
    every seam's check and its call into the plan, a bound on what the
    disarmed seams (one attribute read each) cost. Returns the samples/s
    of each run, the armed mean over the disarmed mean and the seams one
    armed fit passed."""
    import contextlib

    from flinkml_tpu_torch import faults

    class CountingPlan(faults.FaultPlan):
        """Injects nothing; counts the calls of each seam."""

        def __init__(self):
            super().__init__()
            self.sites = {}

        def fire_into(self, site, ctx):
            self.sites[site] = self.sites.get(site, 0) + 1

    rates = {"disarmed": [], "armed": []}
    sites = None
    for armed in (False, True, True, False) * SEAM_ROUNDS:
        plan = CountingPlan()
        with faults.armed(plan) if armed else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        rates["armed" if armed else "disarmed"].append(samples / fit_s)
        if armed:
            sites = plan.sites
    return {"samples_per_s": rates,
            "armed_over_disarmed": float(np.mean(rates["armed"])
                                         / np.mean(rates["disarmed"])),
            "seam_calls_per_armed_fit": sites}


def verdict_trace(torch):
    """The sentinel's verdict alone on FTRL's carry at path G's width (z, n
    and coef, 123 float32 each, and a 0-d float32 loss on the card), over
    ``M1_CHECKS`` checks: host microseconds a check beside a bare
    ``float(loss)`` (the read an FTRL batch makes without a sentinel), and
    from ``torch.profiler`` the device kernels and device microseconds a
    check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flinkml_tpu_torch.recovery import NumericsSentinel

    gen = torch.Generator(device="cuda").manual_seed(3)
    state = {k: torch.randn(FTRL_D, device="cuda", generator=gen)
             for k in ("z", "n", "coef")}
    state["version"] = 1
    loss = torch.rand((), device="cuda", generator=gen)
    sentinel = NumericsSentinel()

    def host_us(call):
        call(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(M1_CHECKS):
            call(i)
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / M1_CHECKS

    check = (lambda i: sentinel.check(state, loss, epoch=i))
    read_us = host_us(lambda i: float(loss))
    check_us = host_us(check)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(M1_CHECKS):
            check(i)
        torch.cuda.synchronize()
    kernels, device_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels += e.count
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    return {"checks": M1_CHECKS, "host_us_per_check": check_us,
            "host_us_per_loss_read": read_us,
            "device_events_per_check": kernels / M1_CHECKS,
            "device_us_per_check": device_us / M1_CHECKS}


def _okm_batches(n, seed):
    """Path I3's drifting blobs: ``n`` batches of 16,384 x 784 float32."""
    rng = np.random.default_rng(seed)
    centers0 = rng.normal(size=(OKM_K, OKM_D)) * 4.0
    drift = rng.normal(size=(OKM_K, OKM_D)) * 0.05
    out = []
    for i in range(n):
        x = rng.standard_normal((OKM_ROWS, OKM_D), dtype=np.float32)
        x += (centers0 + i * drift).astype(np.float32)[
            rng.integers(0, OKM_K, size=OKM_ROWS)]
        out.append(x)
    return out, centers0 + rng.normal(size=centers0.shape) * 0.5


def faults_m1(torch, tmp):
    """M1: FTRL healed on the card under two PoisonBatch, a NaNGrad and a
    CorruptSnapshot of its rollback target, against its golden run (the
    stream without the quarantined batches) bit for bit; batches/s with no
    sentinel, a sentinel every batch and every 8th (each checked fit less
    the unchecked fit of its repeat), and the verdict alone
    (:func:`verdict_trace`); the time to recover from the ``recovery``
    metrics group."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.recovery import NumericsSentinel, RecoveryPolicy
    from flinkml_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(12)
    true = rng.normal(size=FTRL_D)
    tables = []
    for _ in range(FTRL_BATCHES):
        xb = rng.normal(size=(FTRL_ROWS, FTRL_D)).astype(np.float32)
        tables.append(fml.Table({"features": xb,
                                 "label": (xb @ true > 0).astype(np.float32)}))

    def est():
        return (fml.OnlineLogisticRegression().set_alpha(FTRL_ALPHA)
                .set_beta(FTRL_BETA).set_reg(FTRL_REG)
                .set_elastic_net(FTRL_EN))

    est().fit_stream(tables[:2], sentinel=NumericsSentinel())   # warm
    times = {"none": [], "interval_1": [], "interval_8": []}
    for r in range(M1_REPEATS):
        for key in (list(times) * 2)[r % 3:r % 3 + 3]:
            sentinel = {"none": None, "interval_1": NumericsSentinel(),
                        "interval_8": NumericsSentinel(interval=8)}[key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est().fit_stream(tables, sentinel=sentinel)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
    fit_s = {k: float(np.median(v)) for k, v in times.items()}
    # Each repeat's checked fit against its unchecked fit.
    paired = {k: [1e3 * (t - t0) / FTRL_BATCHES
                  for t, t0 in zip(times[k], times["none"])]
              for k in ("interval_1", "interval_8")}
    trace = verdict_trace(torch)
    plan = faults.FaultPlan(
        faults.PoisonBatch(M1_POISON[0]),
        faults.CorruptSnapshot(min_epoch=M1_CORRUPT, target="arrays"),
        faults.NaNGrad(M1_NAN), faults.PoisonBatch(M1_POISON[1]))
    mgr = CheckpointManager(os.path.join(tmp, "m1"), max_to_keep=100)
    with faults.armed(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        healed = est().fit_stream(
            tables, checkpoint_manager=mgr, checkpoint_interval=M1_INTERVAL,
            recovery=RecoveryPolicy(backoff_s=0.0))
        torch.cuda.synchronize()
        healed_s = time.perf_counter() - t0
    gauges = metrics.group("recovery").snapshot()["gauges"]
    quarantined = sorted(M1_POISON + (M1_NAN,))
    golden = est().fit_stream(
        [t for i, t in enumerate(tables) if i not in quarantined])
    fired = sorted({d for _, d, _ in plan.log})
    summary = healed.recovery_summary
    if summary["quarantined"] != quarantined:
        fail(f"path M1: quarantined {summary['quarantined']}, expected "
             f"{quarantined}")
    if len(fired) != 4:
        fail(f"path M1: faults fired {fired}")
    if not np.array_equal(healed.coefficient, golden.coefficient):
        fail("path M1: the healed FTRL differs from its golden run by "
             f"{rel_err(healed.coefficient, golden.coefficient)}")
    if healed.model_version != FTRL_BATCHES - len(quarantined):
        fail(f"path M1: version {healed.model_version}")
    return {
        "batches": FTRL_BATCHES, "batch_rows": FTRL_ROWS, "d": FTRL_D,
        "fit_s_median": fit_s, "fit_s_runs": times,
        "batches_per_s": {k: FTRL_BATCHES / v for k, v in fit_s.items()},
        "sentinel_ms_per_batch": {k: float(np.median(v))
                                  for k, v in paired.items()},
        "sentinel_ms_per_batch_runs": paired, "verdict": trace,
        "healed_fit_s": healed_s, "summary": summary, "fired": fired,
        "time_to_recover_p50_ms": gauges.get("time_to_recover_p50_ms"),
        "time_to_recover_p99_ms": gauges.get("time_to_recover_p99_ms"),
        "healed_equals_golden": True}


def faults_m2(torch):
    """M2: OnlineKMeans at I3's width under a NaNGrad, healed on the card
    (no manager: the rollback is the pristine initial carry), against its
    golden run bit for bit."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.recovery import RecoveryPolicy

    batches, init = _okm_batches(M2_BATCHES, seed=52)
    tables = [fml.Table({"features": x}) for x in batches]

    def est():
        return (fml.OnlineKMeans().set_k(OKM_K).set_decay_factor(OKM_DECAY)
                .set_initial_model_data(fml.Table({"centroids": init[None]})))

    with faults.armed(faults.FaultPlan(faults.NaNGrad(M2_NAN))) as plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        healed = est().fit_stream(tables,
                                  recovery=RecoveryPolicy(backoff_s=0.0))
        torch.cuda.synchronize()
        healed_s = time.perf_counter() - t0
    golden = est().fit_stream(
        [t for i, t in enumerate(tables) if i != M2_NAN])
    if not plan.log or healed.recovery_summary["quarantined"] != [M2_NAN]:
        fail(f"path M2: {healed.recovery_summary}, fired {len(plan.log)}")
    if not np.array_equal(healed.centroids, golden.centroids):
        fail("path M2: the healed OnlineKMeans differs from its golden run "
             f"by {rel_err(healed.centroids, golden.centroids)}")
    return {"batches": M2_BATCHES, "batch_rows": OKM_ROWS, "d": OKM_D,
            "healed_fit_s": healed_s, "summary": healed.recovery_summary,
            "healed_equals_golden": True}


def faults_m3(torch, tmp):
    """M3: the streamed sparse LR at path E's Criteo profile fed as a
    Dataset of SparseVector rows (no prefetcher: the CSR route, ``spmv``
    and the unsorted ``segment_sum`` a step), the epoch-0 cache at half
    its bytes, a snapshot every epoch: disarmed; one snapshotted epoch
    disarmed and under a plan that injects nothing (:func:`seam_abba`: the
    ``data.read`` seam with the checkpoint ones); under a DelayRead (the
    delay shows in epoch 0's feed wait); a RaiseAtRead mid-ingest (the fit
    aborts, nothing trained on a short stream). A Dataset-fed fit reads its source in epoch 0 only and
    ``resume=True`` needs a DataCache (in both packages), so the crash and
    resume run on the sealed cache of the same batches: killed after the
    epoch-``M3_KILL`` commit, resumed within 1e-5 of the uninterrupted
    fit, and the resumed run's newest snapshot corrupted, after which
    ``restore_latest`` walks back one epoch. Returns the record and the
    launch counts of the disarmed Dataset fit (the difference of two
    readings: the path's counters are set to 0 once, before M1)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.data import Dataset
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    rows, dim, nnz = STREAM_ROWS, SPMV_DIM, SPMV_NNZ
    n = M3_BATCHES * rows
    _, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=8)
    table = fml.Table({"features": criteo_rows(indices, values, n, nnz, dim),
                       "label": y.astype(np.float64)})
    dicts = []
    for b in table.batches(rows):
        ip, ix, vx, d, yb, wb = labeled_sparse_data(b, "features", "label",
                                                    None)
        dicts.append({"indptr": np.asarray(ip)[None],
                      "indices": np.asarray(ix)[None],
                      "values": np.asarray(vx)[None],
                      "y": np.asarray(yb)[None], "w": np.asarray(wb)[None],
                      "dim": np.asarray([[d]], np.int64)})
    budget = sum(a.nbytes for b in dicts for a in b.values()) // 2

    def dataset():
        return Dataset.from_arrays(table, batch_size=rows)

    def est(tag, manager=None, resume=False, epochs=M3_EPOCHS):
        return (fml.LogisticRegression(
            cache_dir=os.path.join(tmp, f"m3_{tag}_cache"),
            cache_memory_budget_bytes=budget, checkpoint_manager=manager,
            checkpoint_interval=1 if manager else 0, resume=resume)
            .set_max_iter(epochs).set_tol(0.0).set_learning_rate(STREAM_LR)
            .set_reg(STREAM_REG))

    def sealed():
        w = DataCacheWriter(os.path.join(tmp, f"m3_sealed{len(os.listdir(tmp))}"),
                            budget)
        for b in dicts:
            w.append(b)
        return w.finish()

    est("warm", epochs=1).fit(sealed())    # allocator and kernels warm
    mgr = CheckpointManager(os.path.join(tmp, "m3_main"), max_to_keep=10)
    before = dict(fml.launch_counts())
    with FeedWaits() as feed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main = est("main", mgr).fit(dataset()).coefficient
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in fml.launch_counts().items()}
    steps = M3_BATCHES * M3_EPOCHS
    if counts.get("spmv") != steps or counts.get("segment_sum") != steps:
        fail(f"path M3: launches {counts} in {steps} steps")
    if mgr.all_epochs() != list(range(1, M3_EPOCHS + 1)):
        fail(f"path M3: snapshots {mgr.all_epochs()}")
    cache = sealed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from_cache = est("cache").fit(cache).coefficient
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    errs = {"dataset_vs_cache": rel_err(main, np.asarray(from_cache,
                                                         np.float64))}
    seam_fits = iter(range(4 * SEAM_ROUNDS))

    def snapshotted_epoch():
        tag = f"seam{next(seam_fits)}"
        return est(tag, CheckpointManager(os.path.join(tmp, f"m3_{tag}")),
                   epochs=1).fit(dataset())

    seams = seam_abba(torch, snapshotted_epoch, n)

    plan = faults.FaultPlan(faults.DelayRead(delay_s=M3_DELAY_S))
    with faults.armed(plan), FeedWaits() as delayed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est("delay", epochs=1).fit(dataset())
        torch.cuda.synchronize()
        delay_s = time.perf_counter() - t0
    delay_reads = len(plan.log)

    plan = faults.FaultPlan(faults.RaiseAtRead(at_read=M3_BATCHES // 2 + 1))
    with faults.armed(plan):
        try:
            est("raise").fit(dataset())
            raised = False
        except faults.FaultInjected:
            raised = True
    if not raised or len(plan.log) != 1:
        fail(f"path M3: RaiseAtRead did not abort the fit ({plan.log})")

    kill = CheckpointManager(os.path.join(tmp, "m3_kill"), max_to_keep=10)
    plan = faults.FaultPlan(faults.KillAfterCheckpoint(min_epoch=M3_KILL))
    with faults.armed(plan):
        try:
            est("kill", kill).fit(cache)
            killed = False
        except faults.FaultInjected:
            killed = True
    if not killed or kill.latest_epoch() != M3_KILL:
        fail(f"path M3: the kill left {kill.latest_epoch()}")
    plan = faults.FaultPlan(faults.CorruptSnapshot(min_epoch=M3_EPOCHS))
    with faults.armed(plan):
        resumed = est("resume", kill, resume=True).fit(cache).coefficient
    errs["resumed_vs_uninterrupted"] = rel_err(
        resumed, np.asarray(from_cache, np.float64))
    for what, err in errs.items():
        if not np.isfinite(err) or err > 1e-5:
            fail(f"path M3: {what} differs by {err} of the largest "
                 "coefficient (limit 1e-5)")
    walked = kill.restore_latest(like=(np.zeros(dim, np.float32),
                                       np.float64(0)))
    if not plan.log or walked is None or walked[1] != M3_EPOCHS - 1:
        fail(f"path M3: restore_latest after the corrupt snapshot gave "
             f"{None if walked is None else walked[1]}")
    samples = n * M3_EPOCHS
    return {
        "rows": n, "dim": dim, "nnz": nnz, "batches": M3_BATCHES,
        "batch_rows": rows, "epochs": M3_EPOCHS,
        "dataset_fit_s": fit_s, "dataset_samples_per_s": samples / fit_s,
        "cache_fit_s": cache_s, "cache_samples_per_s": samples / cache_s,
        "seams": seams, "feed_wait_s_per_epoch": feed.waits,
        "delay_read": {"delay_s": M3_DELAY_S, "reads": delay_reads,
                       "fit_s": delay_s,
                       "epoch0_feed_wait_s": delayed.waits[:1],
                       "disarmed_epoch0_feed_wait_s": feed.waits[:1]},
        "raise_at_read_aborted": raised, "killed_at": M3_KILL,
        "walked_back_to": walked[1], "rel_err": errs,
        "launches": counts}, counts


def faults_path(torch):
    """Path M (ROADMAP item 12): M1 FTRL, M2 OnlineKMeans and M3 the
    streamed sparse LR under scripted faults (:func:`faults_m1`,
    :func:`faults_m2`, :func:`faults_m3`), the launch counters set to 0
    once before M1 and read after M2 and after M3; M3's
    :func:`seam_abba` record is held to :data:`SEAM_FLOOR`. Returns M's
    launch counts."""
    import shutil

    import flinkml_tpu_torch as fml

    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        fml.reset_launch_counts()
        m1 = faults_m1(torch, tmp)
        m2 = faults_m2(torch)
        m1_m2_counts = dict(fml.launch_counts())
        m3, m3_counts = faults_m3(torch, tmp)
        counts = dict(fml.launch_counts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("spmv", "segment_sum"):
        if counts.get(name, 0) < m3_counts[name]:
            fail(f"path M: {name} launched {counts.get(name, 0)} times")
    ratio = m3["seams"]["armed_over_disarmed"]
    if not ratio >= SEAM_FLOOR:
        fail(f"path M3: fits whose seams all call a plan ran at {ratio:.3f}x "
             f"the disarmed fits' samples/s (limit {SEAM_FLOOR})")
    log("path " + json.dumps({"path": "faults_M", "M1_ftrl": m1,
                              "M2_online_kmeans": m2, "M3_stream": m3,
                              "launches_M1_M2": m1_m2_counts,
                              "launches": counts}))
    return counts


# -- path N: the serving runtime (engine, registry, pool, gray failure, scaler) --

N_ROWS, N_D = 50_000, 32          # bench.py _serving_stage's model
N1_CLIENTS, N1_SECONDS = 8, 1.0   # the bench runs 4 s; 2.0 until path Y
N1_BATCH_ROWS, N1_WAIT_MS = 256, 1.0
N1_PROFILE_SECONDS = 1.0
N2_SECONDS = 2.0
N3_REPLICAS, N3_CLIENTS, N3_SECONDS = 8, 16, 1.0   # the bench runs 3 s
N3_BATCH_ROWS, N3_WAIT_MS = 128, 2.0
N4_ROWS, N4_PHASE_S = 20_000, 1.5
N5_SECONDS = 1.0
N_DECISION = 2.0 ** -5
N_SHED_BACKOFF_S = 0.001          # a client's pause after a shed request


def n_model(n, d, seed=0):
    """bench.py's ``_five_stage_model``: the four scalers and a two-step
    LogisticRegression fitted by the port (on the card) on seeded data.
    ``(PipelineModel, x)``."""
    import flinkml_tpu_torch as fml

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    cur = fml.Table({"features": x, "label": y})
    stages, prev = [], "features"
    for i, cls in enumerate((fml.StandardScaler, fml.MinMaxScaler,
                             fml.MaxAbsScaler, fml.RobustScaler), start=1):
        m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}").fit(cur)
        (cur,) = m.transform(cur)
        prev = f"s{i}"
        stages.append(m)
    lr = (fml.LogisticRegression()
          .set(fml.LogisticRegression.FEATURES_COL, prev)
          .set(fml.LogisticRegression.LABEL_COL, "label")
          .set_max_iter(2).fit(cur))
    return fml.PipelineModel(stages + [lr]), x


class Responses:
    """What closed-loop clients saw: each response's rows, version,
    outputs, latency and completion time (thread-safe appends)."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.items = []      # (lo, rows, version, columns)
        self.lat = []        # (t_done, ms)
        self.errors = []
        self.sheds = []      # (t, error type) of each request shed

    def add(self, lo, rows, resp, ms, t_done):
        with self.lock:
            self.items.append((lo, rows, resp.version, resp.columns))
            self.lat.append((t_done, ms))

    def p(self, q, t0=None, t1=None):
        with self.lock:
            vals = [ms for tc, ms in self.lat
                    if (t0 is None or tc >= t0) and (t1 is None or tc < t1)]
        return float(np.percentile(vals, q)) if vals else None


def n_load(predict, x, clients, seconds, responses, rows=(1, 33), seed=0,
           during=None, shed=()):
    """``clients`` closed-loop threads (each sends its next request the
    moment the last lands: ``rows`` rows from a seeded offset) for
    ``seconds``; ``during(t0)`` runs in this thread meanwhile. A request
    refused with one of the ``shed`` errors is logged in
    ``responses.sheds`` and the client backs off for N_SHED_BACKOFF_S and
    sends its next one, as ``bench.py``'s clients do; any other error ends
    the client and fails the check. Returns ``(rows served, elapsed s)``."""
    import threading

    stop = threading.Event()
    served = [0] * clients

    def client(tid):
        rng = np.random.default_rng(seed * 1000 + tid)
        try:
            while not stop.is_set():
                r = int(rng.integers(*rows))
                lo = int(rng.integers(0, len(x) - r))
                t0 = time.perf_counter()
                try:
                    resp = predict({"features": x[lo:lo + r]})
                except shed as e:
                    with responses.lock:
                        responses.sheds.append((time.perf_counter(),
                                                type(e).__name__))
                    time.sleep(N_SHED_BACKOFF_S)
                    continue
                t1 = time.perf_counter()
                responses.add(lo, r, resp, (t1 - t0) * 1e3, t1)
                served[tid] += r
        except BaseException as e:  # noqa: BLE001 — the check reports it
            responses.errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        during(t0)
    remaining = seconds - (time.perf_counter() - t0)
    if remaining > 0:
        time.sleep(remaining)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    if any(t.is_alive() for t in threads):
        fail("path N: a client thread hung")
    return sum(served), time.perf_counter() - t0


def n_check(label, responses, refs, cols=("prediction", "rawPrediction")):
    """Every response against its version's float64 numpy chain:
    ``rawPrediction`` within 1e-10, predictions equal where the margin is
    more than 2^-5 from the decision; one version a response."""
    if responses.errors:
        fail(f"path {label}: {len(responses.errors)} requests failed: "
             f"{responses.errors[0]!r}")
    if not responses.items:
        fail(f"path {label}: no response")
    worst = 0.0
    for lo, rows, version, got in responses.items:
        if version not in refs:
            fail(f"path {label}: a response names version {version}")
        _, dot, raw = refs[version]
        sl = slice(lo, lo + rows)
        if got["rawPrediction"].shape != (rows, 2):
            fail(f"path {label}: response shape {got['rawPrediction'].shape}")
        err = float(np.abs(got["rawPrediction"] - raw[sl]).max())
        worst = max(worst, err)
        if not np.allclose(got["rawPrediction"], raw[sl], rtol=1e-10,
                           atol=1e-10):
            fail(f"path {label}: a version-{version} response is {err} from "
                 "its float64 numpy chain (mixed or mis-versioned?)")
        keep = np.abs(dot[sl]) > N_DECISION
        if not np.array_equal(got["prediction"][keep],
                              (dot[sl][keep] >= 0).astype(np.float64)):
            fail(f"path {label}: a prediction differs from numpy")
    return worst


def n_counts():
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.kernels import _build

    return pipeline_fusion.compiled_program_count(), len(_build._LIBS)


def n_profile_batches(torch, engine, x, seconds):
    """N1's load again for ``seconds`` under ``torch.profiler``: the
    card's busy share, and ``fused_chain``'s device time a batch beside
    the batch's wall time (the engine's ``_serve_batch`` timed around)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    serve = engine._serve_batch

    def timed(batch):
        t0 = time.perf_counter()
        serve(batch)
        walls.append((time.perf_counter() - t0) * 1e3)

    engine._serve_batch = timed
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n_load(engine.predict, x, N1_CLIENTS, seconds, Responses(),
                   seed=3)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:   # the profiler, not the path, failed
        log(f"path N1 profile not measured: {e}")
        return {"busy_share": None}
    finally:
        del engine._serve_batch
    busy_us = chain_us = 0.0
    chain_n = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            busy_us += t
            if "chain" in e.key:
                chain_us += t
                chain_n += e.count
    return {
        "busy_share": busy_us / wall_us if busy_us > 0 else None,
        "fused_chain_device_ms_per_batch": (chain_us / chain_n / 1e3
                                            if chain_n else None),
        "batch_wall_ms_mean": float(np.mean(walls)) if walls else None,
        "batch_wall_ms_p50": float(np.median(walls)) if walls else None,
        "profiled_batches": len(walls), "profiled_launches": chain_n,
    }


def serving_n1_n2(torch, tmp, v1, x):
    """N1 (``bench.py:662 _serving_stage``) and N2 (registry, hot swap,
    rollback, ``DropPublish``, a NaN model refused) on one engine that
    follows a ``ModelRegistry``."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.recovery import NonFiniteModelError
    from flinkml_tpu_torch.serving import (
        ModelRegistry,
        ServingConfig,
        ServingEngine,
    )

    v2, _ = n_model(N_ROWS, N_D, seed=1)  # the same chain, data seed 1
    refs = {1: numpy_chain(v1, x), 2: numpy_chain(v2, x)}
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    reg.publish(v1)
    engine = ServingEngine(
        reg, fml.Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=N1_BATCH_ROWS, max_wait_ms=N1_WAIT_MS),
        output_cols=("prediction", "rawPrediction"), name="n1",
    )
    rec = {"path": "serving_N1", "rows": N_ROWS, "d": N_D,
           "clients": N1_CLIENTS, "seconds": N1_SECONDS}
    try:
        engine.start().follow_registry()
        if engine.device.type != "cuda" or engine._stream is None:
            fail(f"path N1: the engine serves on {engine.device}")
        warm = n_counts()
        buckets = int(engine.stats()["gauges"]["warmed_buckets"])
        n1 = Responses()
        rows, elapsed = n_load(engine.predict, x, N1_CLIENTS, N1_SECONDS, n1)
        if n_counts() != warm:
            fail(f"path N1: programs or kernel builds {warm} -> "
                 f"{n_counts()} after warmup")
        rec["max_abs_err"] = n_check("N1", n1, refs)
        st = engine.stats()
        c = st["counters"]
        if {v for _, _, v, _ in n1.items} != {1}:
            fail("path N1: a response not from version 1")
        rec.update({
            "rows_per_s": rows / elapsed, "requests": len(n1.items),
            "batches": int(c["batches"]),
            "occupancy": c["batch_rows"] / c["batch_padded_rows"],
            "engine_p50_ms": st["gauges"]["p50_ms"],
            "engine_p99_ms": st["gauges"]["p99_ms"],
            "client_p50_ms": n1.p(50), "client_p99_ms": n1.p(99),
            "warm_buckets": buckets,
        })
        rec.update(n_profile_batches(torch, engine, x, N1_PROFILE_SECONDS))

        # N2: publish v2 under load, then roll back to v1.
        n2 = Responses()
        marks = {}

        def swaps(t0):
            time.sleep(0.5)
            marks["publish"] = time.perf_counter()
            reg.publish(v2)
            marks["published"] = time.perf_counter()
            time.sleep(1.0)
            marks["rollback"] = time.perf_counter()
            reg.rollback(1)
            marks["rolled_back"] = time.perf_counter()

        before = dict(engine.stats()["counters"])
        n_load(engine.predict, x, N1_CLIENTS, N2_SECONDS, n2, seed=1,
               during=swaps)
        rec2 = {"path": "serving_N2", "max_abs_err": n_check("N2", n2, refs)}
        after = engine.stats()["counters"]
        seen = [(t, v) for (t, _), (_, _, v, _) in zip(n2.lat, n2.items)]
        v2_at = [t for t, v in seen if v == 2]
        if not v2_at:
            fail("path N2: no response from version 2 after its publish")
        late_v1 = [t for t, v in seen if v == 1 and
                   marks["published"] < t < marks["rollback"]]
        if engine.active_version != 1:
            fail(f"path N2: version {engine.active_version} active after "
                 "rollback(1)")
        rec2.update({
            "publish_to_first_v2_ms": (min(v2_at) - marks["publish"]) * 1e3,
            "publish_s": marks["published"] - marks["publish"],
            "rollback_s": marks["rolled_back"] - marks["rollback"],
            "responses": len(n2.items),
            "v2_responses": len(v2_at),
            "v1_completed_between_publish_and_rollback": len(late_v1),
            "redispatched_for_version": after.get(
                "redispatched_for_version", 0) - before.get(
                "redispatched_for_version", 0),
            "errors": after.get("errors", 0) - before.get("errors", 0),
            "swaps": after.get("swaps", 0) - before.get("swaps", 0),
        })
        if rec2["errors"]:
            fail(f"path N2: {rec2['errors']} batches failed")

        # A dropped publish leaves the registry as it was.
        versions = reg.versions()
        with faults.armed(faults.FaultPlan(faults.DropPublish(at_publish=1))):
            try:
                reg.publish(v2)
                fail("path N2: DropPublish did not drop the publish")
            except faults.FaultInjected:
                pass
        if reg.versions() != versions or reg.current_version() != 1:
            fail("path N2: a dropped publish changed the registry")
        # A NaN model: refused at publish, and (published unchecked) at
        # install, while v1 keeps serving.
        bad = reg.get(1)[1]
        coef = np.array(bad.stages[-1].coefficient, dtype=np.float64)
        coef[0] = np.nan
        bad.stages[-1].set_model_data(fml.Table({"coefficient": coef[None]}))
        try:
            reg.publish(bad)
            fail("path N2: a NaN model was published")
        except NonFiniteModelError:
            pass
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reg.publish(bad, check_finite=False)
        if not any("listener" in str(w.message) for w in caught):
            fail("path N2: the follower did not refuse the NaN model")
        resp = engine.predict({"features": x[:64]})
        if resp.version != 1 or engine.active_version != 1:
            fail("path N2: v1 stopped serving after the NaN publish")
        rec2["nan_model"] = "refused at publish and at install; v1 serving"
        rec2["drop_publish"] = "registry untouched"
        rec["launch_identity"] = {
            "full_loads": int(engine.stats()["counters"]["full_loads"]),
            "batches": int(engine.stats()["counters"]["batches"]),
            "buckets": buckets}
    finally:
        engine.stop()
    log("path " + json.dumps(rec))
    log("path " + json.dumps(rec2))
    return rec, rec2


def serving_n3(torch, model, x):
    """N3 (``bench.py:736 _serving_scaleout_stage``): one engine, then an
    8-replica pool on the one card under FIFO and continuous batching."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.serving import (
        ReplicaPool,
        ServingConfig,
        ServingEngine,
    )

    refs = {None: numpy_chain(model, x)}
    example = fml.Table({"features": x[:4]})
    out = {"path": "serving_N3", "replicas": N3_REPLICAS,
           "clients": N3_CLIENTS, "seconds": N3_SECONDS}

    def cfg(**kw):
        return ServingConfig(max_batch_rows=N3_BATCH_ROWS,
                             max_wait_ms=N3_WAIT_MS, **kw)

    def measure(label, server):
        got = Responses()
        rows, elapsed = n_load(server.predict, x, N3_CLIENTS, N3_SECONDS,
                               got, seed=4)
        out[f"{label}_max_abs_err"] = n_check(f"N3 {label}", got, refs)
        out[f"{label}_rows_per_s"] = rows / elapsed
        out[f"{label}_p50_ms"] = got.p(50)
        out[f"{label}_p99_ms"] = got.p(99)

    engine = ServingEngine(model, example, cfg(),
                           output_cols=("prediction", "rawPrediction"),
                           name="n3_single").start()
    try:
        measure("single", engine)
    finally:
        engine.stop()
    for batching in ("fifo", "continuous"):
        pool = ReplicaPool(
            model, example, config=cfg(batching=batching),
            n_replicas=N3_REPLICAS,
            output_cols=("prediction", "rawPrediction"),
            name=f"n3_{batching}",
        )
        try:
            t0 = time.perf_counter()
            pool.start()
            out[f"{batching}_start_s"] = time.perf_counter() - t0
            streams = {id(r.engine._stream) for r in pool.replicas}
            if (len(streams) != N3_REPLICAS
                    or any(r.engine.device.type != "cuda"
                           for r in pool.replicas)):
                fail("path N3: replicas do not each own a stream on the card")
            measure(batching, pool)
            out[f"{batching}_per_replica_requests"] = [
                int(r["counters"].get("requests", 0))
                for r in pool.stats()["per_replica"].values()]
        finally:
            pool.stop()
    out["rows_per_s_per_replica"] = out["continuous_rows_per_s"] / N3_REPLICAS
    out["pool_over_single"] = (out["continuous_rows_per_s"]
                               / out["single_rows_per_s"])
    out["continuous_minus_fifo_p50_ms"] = (out["continuous_p50_ms"]
                                           - out["fifo_p50_ms"])
    log("path " + json.dumps(out))
    return out


def serving_n4(torch, model, x):
    """N4 (``bench.py:1235 _serving_grayfail_stage``): 4 replicas under
    ``serving_grayfail_policy()``, r1 stalled 0.2 s a batch."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.recovery.fuzz import serving_grayfail_policy
    from flinkml_tpu_torch.serving import (
        ReplicaPool,
        ReplicaState,
        ServingConfig,
    )

    refs = {None: numpy_chain(model, x)}
    pool = ReplicaPool(
        model, fml.Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=128, max_queue_rows=512,
                             max_wait_ms=1.0, default_timeout_ms=15_000.0),
        n_replicas=4, output_cols=("prediction", "rawPrediction"),
        name="n4", grayfail=serving_grayfail_policy(),
    ).start()
    guard = pool.grayfail_guard(interval_s=0.05).start()
    got = Responses()
    marks = {}
    r1 = pool.replicas[1]

    def phases(t0):
        time.sleep(N4_PHASE_S)     # baseline (also seeds attempt rings)
        marks["stall"] = time.perf_counter()
        with faults.armed(faults.FaultPlan(
                faults.StallDispatch("r1", delay_s=0.2))):
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if r1.health.state is ReplicaState.SLOW:
                    marks["quarantine"] = time.perf_counter()
                    break
                time.sleep(0.02)
            time.sleep(N4_PHASE_S / 2)
        marks["cleared"] = time.perf_counter()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if r1.health.state is ReplicaState.HEALTHY:
                marks["rejoin"] = time.perf_counter()
                break
            time.sleep(0.02)
        marks["recovered_from"] = marks.get("rejoin", marks["cleared"])
        time.sleep(N4_PHASE_S / 2)

    try:
        rows, elapsed = n_load(pool.predict, x, 4, 0.0, got, rows=(16, 49),
                               seed=5, during=phases)
        router = pool.stats()["router"]
        gcount = guard._metrics.snapshot()["counters"]
    finally:
        guard.stop()
        pool.stop(drain=False, timeout=30.0)
    err = n_check("N4", got, refs)
    base = got.p(99, None, marks["stall"])
    stall = got.p(99, marks["stall"], marks["cleared"])
    recovered = got.p(99, marks["recovered_from"])
    hedged = router.get("hedges_dispatched", 0.0)
    rec = {"path": "serving_N4", "rows": N4_ROWS, "max_abs_err": err,
           "rows_per_s": rows / elapsed, "baseline_p99_ms": base,
           "p99_during_stall_ms": stall, "recovered_p99_ms": recovered,
           "time_to_quarantine_s": (marks["quarantine"] - marks["stall"]
                                    if "quarantine" in marks else None),
           "time_to_rejoin_s": (marks["rejoin"] - marks["cleared"]
                                if "rejoin" in marks else None),
           "hedge_win_fraction": (router.get("hedges_won", 0.0) / hedged
                                  if hedged else 0.0),
           "hedges_dispatched": int(hedged),
           "abandoned_attempts": int(router.get("abandoned_attempts", 0.0)),
           "quarantines_total": int(gcount.get("quarantines_total", 0)),
           "rejoins_total": int(gcount.get("rejoins_total", 0))}
    log("path " + json.dumps(rec))
    if "quarantine" not in marks:
        fail("path N4: the stalled replica was never quarantined")
    if "rejoin" not in marks:
        fail("path N4: the stalled replica never rejoined")
    bound = max(2.0 * base, base + 50.0)
    if recovered is None or recovered > bound:
        fail(f"path N4: recovered p99 {recovered} ms > {bound:.1f} ms "
             f"(baseline {base:.1f} ms)")
    return rec


def serving_n5(torch, model, x):
    """N5: the closed loop of ``bench.py:1030 _serving_autoscale_stage`` —
    a 1-replica pool whose offered load triples, scaled by a
    ``PoolAutoscaler`` with no operator; then the serving soak
    (``run_serving_soak(seed=7, budget=2)``) on the card."""
    import threading

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.recovery.fuzz import run_serving_soak
    from flinkml_tpu_torch.serving import (
        AutoscaleConfig,
        PoolAutoscaler,
        ReplicaPool,
        PoolUnavailableError,
        ServingConfig,
        ServingOverloadError,
    )

    # The bench's clients back off on these: a full queue, and the one
    # replica DRAINING after it tripped its queue bound (the router's
    # load shedding, as in the JAX package).
    shed = (ServingOverloadError, PoolUnavailableError)
    refs = {None: numpy_chain(model, x)}
    pool = ReplicaPool(
        model, fml.Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=128, max_queue_rows=256,
                             max_wait_ms=1.0),
        n_replicas=1, output_cols=("prediction", "rawPrediction"),
        name="n5",
    ).start()
    scaler = PoolAutoscaler(pool, AutoscaleConfig(
        min_replicas=1, max_replicas=4, up_consecutive=10,
        down_consecutive=10_000, cooldown_s=0.3, interval_s=0.1,
    )).start()
    light, heavy = Responses(), Responses()
    marks = {}

    def spike(t0):
        time.sleep(N5_SECONDS / 2)
        marks["spike"] = time.perf_counter()
        rows, _ = n_load(pool.predict, x, 4, 0.0, heavy, rows=(16, 49),
                         seed=7, during=settle, shed=shed)
        marks["heavy_rows"] = rows

    def settle(t0):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(pool.replicas) < 2:
            time.sleep(0.05)
        marks["scaled"] = time.perf_counter()
        stable, last = time.monotonic(), len(pool.replicas)
        while time.monotonic() < deadline:
            if len(pool.replicas) != last:
                last, stable = len(pool.replicas), time.monotonic()
            if time.monotonic() - stable >= 1.0:
                break
            time.sleep(0.05)
        marks["settled"] = time.perf_counter()
        time.sleep(N5_SECONDS)
        marks["end"] = time.perf_counter()

    try:
        n_load(pool.predict, x, 2, 0.0, light, rows=(16, 49), seed=6,
               during=spike, shed=shed)
        st = scaler.stats()
    finally:
        scaler.stop()
        pool.stop()
    for label, got in (("N5 light", light), ("N5 heavy", heavy)):
        n_check(label, got, refs)
    both = Responses()
    both.lat = light.lat + heavy.lat
    sheds = light.sheds + heavy.sheds

    def shed_in(t0, t1):
        return sum(1 for t, _ in sheds if t0 <= t < t1)

    rec = {"path": "serving_N5",
           "spike_p99_ms": both.p(99, marks["spike"], marks["scaled"]),
           "recovered_p99_ms": both.p(99, marks["settled"], marks["end"]),
           "seconds_to_first_scale": marks["scaled"] - marks["spike"],
           # 6 clients of up to 48 rows outrun one replica's 256-row queue:
           # the pool may shed until it scales.
           "shed_requests": {k: sum(1 for _, n in sheds if n == k)
                             for k in sorted({n for _, n in sheds})},
           "shed_before_scale": shed_in(marks["spike"], marks["scaled"]),
           "shed_recovered": shed_in(marks["settled"], marks["end"]),
           "replicas": st["replicas"], "counters": st["counters"],
           "backlog_ewma": st["backlog_ewma"]}
    if st["counters"].get("scale_up_total", 0) < 1:
        fail(f"path N5: the autoscaler never scaled up ({st})")
    t0 = time.perf_counter()
    report = run_serving_soak(seed=7, budget=2)
    rec["soak"] = {"summary": report.summary(),
                   "seconds": time.perf_counter() - t0,
                   "stats": [r.stats for r in report.results]}
    log("path " + json.dumps(rec))
    if not report.ok:
        fail(f"path N5: serving soak failed: "
             f"{[r.failures for r in report.failures]}")
    return rec


def serving_path(torch):
    """Path N (ROADMAP item 4): the serving runtime at the bench's widths
    (:func:`serving_n1_n2`, :func:`serving_n3`, :func:`serving_n4`,
    :func:`serving_n5`), the launch counters set to 0 just before and read
    just after. Every batch of every engine is one ``fused_chain`` launch:
    N1 and N2's engine launches one a warmed bucket a full load plus one a
    batch. Returns N's launch counts."""
    import shutil

    import flinkml_tpu_torch as fml

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        v1, x = n_model(N_ROWS, N_D, seed=0)
        small, xs = n_model(N4_ROWS, N_D, seed=0)
        fml.reset_launch_counts()
        n1, _ = serving_n1_n2(torch, tmp, v1, x)
        n12 = dict(fml.launch_counts())
        serving_n3(torch, v1, x)
        serving_n4(torch, small, xs)
        serving_n5(torch, small, xs)
        counts = dict(fml.launch_counts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ident = n1["launch_identity"]
    want = ident["buckets"] * ident["full_loads"] + ident["batches"]
    # N1's profiled load is a load like the others; launches and batches
    # are both counted by the engine.
    if n12.get("fused_chain", 0) != want:
        fail(f"path N1-N2: fused_chain launched {n12.get('fused_chain', 0)} "
             f"times, expected {want} (warmed buckets x full loads + "
             "batches)")
    if counts.get("fused_chain", 0) <= n12["fused_chain"]:
        fail("path N3-N5: fused_chain never launched")
    log("path " + json.dumps({"path": "serving_N", "launches": counts,
                              "launches_N1_N2": n12}))
    return counts


# -- path O: the cluster runtime (worker processes, ClusterPool, elastic worlds) --

O_WORKERS, O_CLIENTS, O_SECONDS = 2, 4, 1.0      # bench.py _multiproc_pool_stage; 2.0 until path Y
O_BATCH_ROWS, O_WAIT_MS = 128, 2.0
O_CRASH_EXIT, O_CRASH_SECONDS = 23, 1.5   # the crash lands at 0.5 s
O_PARITY_ROWS = 4096                 # rows served through both, 32 a request
O_CHILD_TIMEOUT_S = 120


def o_parity(ref, pool, x):
    """The first O_PARITY_ROWS rows through the in-process engine and the
    pool, 1–32 rows a request: ``(bit for bit, requests)``."""
    rng = np.random.default_rng(8)
    lo, same, n = 0, True, 0
    while lo < O_PARITY_ROWS:
        rows = int(rng.integers(1, 33))
        req = {"features": x[lo:lo + rows]}
        a, b = ref.predict(req), pool.predict(req)
        for c in ("prediction", "rawPrediction"):
            same &= bool(np.array_equal(a.column(c), b.column(c)))
        lo += rows
        n += 1
    return same, n


def cluster_o1_o2(torch, model, x):
    """O1 (``bench.py:899 _multiproc_pool_stage``): an in-process
    ``ReplicaPool`` of 2 and a ``ClusterPool`` of 2 workers on the one card,
    4 closed-loop clients of 1–32 rows each for 1 s; O2 on the same
    workers: a ``WorkerCrash`` armed over the transport mid-traffic, the
    respawn, a lease reclaimed over the wire, the metrics. Returns
    ``(O1's record, O2's record, {worker: its last fused_chain count})``."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.cluster import ClusterPool, reclaim_worker_leases
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.serving import (
        ReplicaPool,
        ServingConfig,
        ServingEngine,
    )

    refs = {None: numpy_chain(model, x)}
    example = fml.Table({"features": x[:4]})
    cfg = ServingConfig(max_batch_rows=O_BATCH_ROWS, max_wait_ms=O_WAIT_MS)
    cols = ("prediction", "rawPrediction")
    rec = {"path": "cluster_O1", "workers": O_WORKERS,
           "clients": O_CLIENTS, "seconds": O_SECONDS}
    rec2 = {"path": "cluster_O2"}

    def measure(label, server):
        got = Responses()
        rows, elapsed = n_load(server.predict, x, O_CLIENTS, O_SECONDS, got,
                               seed=6)
        rec[f"{label}_max_abs_err"] = n_check(f"O1 {label}", got, refs)
        rec[f"{label}_rows_per_s"] = rows / elapsed
        rec[f"{label}_p50_ms"] = got.p(50)
        rec[f"{label}_p99_ms"] = got.p(99)

    threads = ReplicaPool(model, example, config=cfg, n_replicas=O_WORKERS,
                          output_cols=cols, name="o1_threads").start()
    try:
        measure("threads", threads)
    finally:
        threads.stop()
    ref = ServingEngine(model, example, cfg, output_cols=cols,
                        name="o_ref").start()
    pool = ClusterPool(model, example, config=cfg, n_workers=O_WORKERS,
                       output_cols=cols, name="o_workers")
    last = {}
    try:
        t0 = time.perf_counter()
        pool.start()
        rec["start_s"] = time.perf_counter() - t0
        rec["spawn_ms"] = [r.engine.process.spawn_ms for r in pool.replicas]
        rec["spawn_stage_ms"] = [r.engine.process.spawn_stage_ms
                                 for r in pool.replicas]
        measure("workers", pool)
        rec["workers_over_threads"] = (rec["workers_rows_per_s"]
                                       / rec["threads_rows_per_s"])
        snap = pool.cluster_metrics.snapshot()["gauges"]
        rec["transport_p50_ms"] = snap.get("p50_ms")
        rec["transport_p99_ms"] = snap.get("p99_ms")
        same, n = o_parity(ref, pool, x)
        if not same:
            fail("path O1: a worker's response differs from the in-process "
                 "engine's bits")
        rec["parity_requests"] = n
        before = {}
        for r in pool.replicas:
            st = r.engine.worker_stats()
            if not st["device"].startswith("cuda"):
                fail(f"path O1: worker {r.name} serves on {st['device']}")
            if st["nvcc_runs"] != 0:
                fail(f"path O1: worker {r.name} ran nvcc {st['nvcc_runs']} "
                     "times (the pool builds the kernels before the spawn)")
            if st["launches"].get("fused_chain", 0) <= 0:
                fail(f"path O1: worker {r.name} launched no fused_chain")
            if st["compile_cache"].get("hits", 0) < len(_build.sources()):
                fail(f"path O1: worker {r.name} loaded "
                     f"{st['compile_cache']} from the store")
            before[r.name] = st
            last[r.name] = st["launches"]["fused_chain"]
        rec["worker_launches"] = dict(last)
        rec["worker_programs"] = {k: v["compiled_programs"]
                                  for k, v in before.items()}
        rec["worker_store"] = {k: v["compile_cache"]
                               for k, v in before.items()}

        # O2: a crash mid-traffic, armed over the transport.
        victim = pool.replicas[0]
        marker = os.path.join(victim.engine.process.workdir, "crash.marker")
        plan = faults.plan_to_json(faults.FaultPlan(faults.WorkerCrash(
            at=1, key="request", exit_code=O_CRASH_EXIT, marker=marker)))

        def crash(t0):
            time.sleep(0.5)
            victim.engine.client.call("arm_faults", {"plan_json": plan})
            deadline = time.monotonic() + 20.0
            while victim.engine.process.alive and time.monotonic() < deadline:
                time.sleep(0.02)
            rec2["crash_s"] = time.perf_counter() - t0

        got = Responses()
        n_load(pool.predict, x, O_CLIENTS, O_CRASH_SECONDS, got, seed=7,
               during=crash)
        rec2["max_abs_err"] = n_check("O2", got, refs)   # 0 requests lost
        rec2["requests"] = len(got.items)
        rec2["crashed_rc"] = victim.engine.process.returncode
        if rec2["crashed_rc"] != O_CRASH_EXIT:
            fail(f"path O2: the worker exited {rec2['crashed_rc']}")
        health = {r.name: r.health.state.name for r in pool.replicas}
        rec2["health_after_crash"] = health
        if health.get("r1") != "HEALTHY":
            fail(f"path O2: the survivor is {health.get('r1')}")
        survivor = pool.replicas[1].engine.worker_stats()
        last["r1"] = survivor["launches"]["fused_chain"]
        t0 = time.perf_counter()
        (successor,) = pool.respawn_dead()
        rec2["respawn_s"] = time.perf_counter() - t0
        warm = successor.engine.worker_stats()
        same, _ = o_parity(ref, pool, x)
        if not same:
            fail("path O2: parity broke after the respawn")
        after = successor.engine.worker_stats()
        rec2["respawn_nvcc_runs"] = warm["nvcc_runs"]
        rec2["respawn_programs"] = [warm["compiled_programs"],
                                    after["compiled_programs"]]
        if warm["nvcc_runs"] != 0:
            fail(f"path O2: the respawned worker ran nvcc {warm['nvcc_runs']}"
                 " times")
        rec2["respawn_store"] = warm["compile_cache"]
        if warm["compile_cache"].get("hits", 0) < len(_build.sources()):
            fail(f"path O2: the respawned worker loaded "
                 f"{warm['compile_cache']} from the store")
        if not (warm["compiled_programs"] == after["compiled_programs"]
                == before["r0"]["compiled_programs"]):
            fail(f"path O2: programs {before['r0']['compiled_programs']} "
                 f"(predecessor) -> {warm['compiled_programs']} (warm) -> "
                 f"{after['compiled_programs']} (after traffic)")
        client = successor.engine.client
        acquired = client.call("lease", {"cmd": "acquire",
                                         "holder": "o2-trainer",
                                         "cooperative": True})
        reclaimed = reclaim_worker_leases(
            client, device_ids=acquired["devices"], timeout_s=10.0)
        if not reclaimed or not all(r["released"] for r in reclaimed):
            fail(f"path O2: lease reclaim over the wire: {reclaimed}")
        rec2["lease_reclaimed"] = len(reclaimed)
        snap = pool.cluster_metrics.snapshot()
        rec2["workers_alive"] = snap["gauges"].get("workers_alive")
        rec2["spawn_ms"] = snap["histories"].get("spawn_ms", [])
        rec2["transport_p99_ms"] = snap["gauges"].get("p99_ms")
        if (rec2["workers_alive"] != 2.0 or len(rec2["spawn_ms"]) != 3
                or rec2["transport_p99_ms"] is None):
            fail(f"path O2: metrics {snap['gauges']} spawn_ms "
                 f"{rec2['spawn_ms']}")
        for r in pool.replicas:
            if r.engine.process.alive:
                last[r.name] = r.engine.worker_stats()["launches"][
                    "fused_chain"]
        rec2["worker_launches"] = dict(last)
    finally:
        pool.stop()
        ref.stop()
    log("path " + json.dumps(rec))
    log("path " + json.dumps(rec2))
    return rec, rec2, last


def cluster_o3(torch):
    """O3: ``tests/_torch_elastic_rank.py``'s scenario on the card — two
    gloo ranks on ``cuda:0``, rank 1 exits through ``WorkerCrash``,
    ``ElasticProcessWorld.run(2, min_world=1)`` resumes the survivor at
    world 1 from the crash-time epoch; the result equals a continuous
    golden run (started beside it) bit for bit."""
    from flinkml_tpu_torch.cluster import ElasticProcessWorld
    from flinkml_tpu_torch.cluster.elastic import DEVICE_VAR

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "tests", "_torch_elastic_rank.py")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (here, os.environ.get("PYTHONPATH")) if x))
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        world = ElasticProcessWorld(
            lambda rank, w, rnd: [sys.executable, script, wd], env=env,
            workdir=wd, round_timeout_s=O_CHILD_TIMEOUT_S)
        golden = subprocess.Popen(
            [sys.executable, script, wd, "golden"],
            env=dict(env, **{DEVICE_VAR: world.device}),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        try:
            final = world.run(2, min_world=1)
        finally:
            try:
                _, err = golden.communicate(timeout=O_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                golden.kill()
                golden.communicate()
                fail("path O3: the golden run hung")
        if golden.returncode != 0:
            fail(f"path O3: the golden run exited {golden.returncode}: "
                 f"{err.decode(errors='replace')[-2000:]}")
        res = json.load(open(os.path.join(wd, "result.json")))
        gold = json.load(open(os.path.join(wd, "result-golden.json")))
        rounds = [{k: r[k] for k in ("world", "exit_codes", "lost",
                                     "elapsed_s")} for r in world.rounds]
    rec = {"path": "cluster_O3", "final_world": final, "rounds": rounds,
           "resumed_from": res["resumed_from"], "device": res["device"],
           "seconds": time.perf_counter() - t0}
    if final != 1 or rounds[0]["lost"] != 1 or \
            O_CRASH_EXIT not in rounds[0]["exit_codes"]:
        fail(f"path O3: the world did not shrink 2 -> 1: {rounds}")
    if not res["device"].startswith("cuda") or res["resumed_from"] <= 0:
        fail(f"path O3: resumed from {res['resumed_from']} on "
             f"{res['device']}")
    if res["w"] != gold["w"] or res["rows"] != gold["rows"]:
        fail("path O3: the resumed world differs from the golden run")
    log("path " + json.dumps(rec))
    return rec


def cluster_path(torch):
    """Path O (ROADMAP item 19): the cluster runtime on the one card
    (:func:`cluster_o1_o2`, :func:`cluster_o3`), the chain fitted by the
    port on the card at N1's widths. This process's launch counters are
    set to 0 just before and read just after; each worker counts its own
    from its start, read over the transport (``stats``). Returns
    ``(the workers' summed fused_chain launches, this process's)``."""
    import flinkml_tpu_torch as fml

    model, x = n_model(N_ROWS, N_D, seed=0)
    fml.reset_launch_counts()
    _, _, workers = cluster_o1_o2(torch, model, x)
    cluster_o3(torch)
    here = dict(fml.launch_counts())
    if here.get("fused_chain", 0) <= 0:
        fail("path O: the in-process pool launched no fused_chain")
    total = sum(workers.values())
    log("path " + json.dumps({"path": "cluster_O", "worker_launches":
                              workers, "launches": here}))
    return total, here["fused_chain"]



def o_scaleout_main() -> int:
    """``chip_smoke.py --o-scaleout``: path N3's load (16 closed-loop
    clients of 1–32 rows, 1 s, 128-row buckets, 2 ms window) against one
    engine, an 8-replica in-process ``ReplicaPool`` and an 8-worker
    ``ClusterPool`` on the one card, in that order, then the engine again;
    prints one JSON line. Not a path of the smoke test: it measures whether
    replicas as processes lift N3's 0.15x."""
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.cluster import ClusterPool
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.serving import (
        ReplicaPool,
        ServingConfig,
        ServingEngine,
    )

    if not torch.cuda.is_available():
        fail("--o-scaleout needs the card")
    _build.build_all()
    model, x = n_model(N_ROWS, N_D, seed=0)
    refs = {None: numpy_chain(model, x)}
    example = fml.Table({"features": x[:4]})
    cfg = ServingConfig(max_batch_rows=N3_BATCH_ROWS, max_wait_ms=N3_WAIT_MS)
    cols = ("prediction", "rawPrediction")
    out = {"card": card_line(), "replicas": N3_REPLICAS,
           "clients": N3_CLIENTS, "seconds": N3_SECONDS}

    def measure(label, server):
        got = Responses()
        rows, elapsed = n_load(server.predict, x, N3_CLIENTS, N3_SECONDS,
                               got, seed=4)
        out[f"{label}_max_abs_err"] = n_check(f"scale-out {label}", got,
                                              refs)
        out[f"{label}_rows_per_s"] = rows / elapsed
        out[f"{label}_p50_ms"] = got.p(50)
        out[f"{label}_p99_ms"] = got.p(99)

    for label, make in (
            ("single", lambda: ServingEngine(model, example, cfg,
                                             output_cols=cols, name="o_one")),
            ("threads", lambda: ReplicaPool(model, example, config=cfg,
                                            n_replicas=N3_REPLICAS,
                                            output_cols=cols,
                                            name="o_threads")),
            ("workers", lambda: ClusterPool(model, example, config=cfg,
                                            n_workers=N3_REPLICAS,
                                            output_cols=cols,
                                            name="o_workers8")),
            ("single_again", lambda: ServingEngine(model, example, cfg,
                                                   output_cols=cols,
                                                   name="o_one_again"))):
        server = make()
        t0 = time.perf_counter()
        server.start()
        out[f"{label}_start_s"] = time.perf_counter() - t0
        try:
            measure(label, server)
        finally:
            server.stop()
    for label in ("threads", "workers"):
        out[f"{label}_over_single"] = (out[f"{label}_rows_per_s"]
                                       / out["single_rows_per_s"])
    print(json.dumps(out), flush=True)
    return 0

# -- paths P-S: tensor parallelism, ALS, embeddings, hashed features ---------------

#: Paths P-S's device (a rehearsal on the CPU sets "cpu").
PS_DEVICE = "cuda"
#: Path P and R2's ranks: two gloo ranks on the one card (J2's set-up).
PR_WORLD, PR_BACKEND, PR_TIMEOUT_S = 2, "gloo", 600
# Path P: a Transformer-base-like block (d_model 1024, d_ff 4096, 16 heads
# of 64), float32.
P_TOKENS, P_D, P_DFF = 8192, 1024, 4096
P_EXPERTS, P_CAPACITY = 2, 1.25
P_MICRO, P_MB_ROWS = 8, 1024
P_HEADS, P_SEQ, P_HEAD_D = 16, 8192, 64
#: Path P's tolerance: max abs error at most this share of the largest
#: magnitude of the same computation unsharded on the card.
P_TOL = 2e-4
# Path Q: bench.py's _inner_als shape; ITERS cut from the bench's 10.
Q_USERS, Q_ITEMS, Q_NNZ, Q_RANK = 16_384, 16_384, 1 << 21, 32
Q_ITERS, Q_STREAM_ITERS, Q_STREAM_BATCHES = 3, 2, 8
Q_CHECK_USERS, Q_SERVE_ROWS, Q_SERVE_IDS = 256, 4096, 4
#: Ratings of the fit held against the CPU port's (a quarter: the CPU fit
#: of all 2^21 took 15 s of the script).
Q_CPU_NNZ = 1 << 17
#: ALS tolerance between two reductions (the JAX package's own).
Q_RTOL, Q_ATOL = 5e-4, 5e-5
# Path R: bench.py's _sharded_embedding_stage shape.
R_VOCAB, R_DIM, R_BATCH, R_REPS = 1 << 20, 16, 1 << 13, 8
#: The bench's budget, for its 8 devices (16 MB a shard fits, 32 MB at
#: fsdp only and 128 MB replicated do not); R2's two ranks keep that
#: contract at 4 times the budget (64 MB a shard of two).
R_BUDGET = 24 << 20
R2_BUDGET = 4 * R_BUDGET
# Path S: bench.py's _feature_freshness_stage shape.
S_BUCKETS, S_ROWS, S_LEN, S_FACTOR, S_PUBLISHES = 1 << 16, 512, 4, 16, 32


def ps_sync(torch):
    if PS_DEVICE == "cuda":
        torch.cuda.synchronize()


def ps_seconds(torch, fn):
    """``(seconds, result)`` of one call, synchronized on the card."""
    ps_sync(torch)
    t0 = time.perf_counter()
    out = fn()
    ps_sync(torch)
    return time.perf_counter() - t0, out


def p_inputs():
    """Path P's seeded float32 inputs (numpy)."""
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "x": normal(P_TOKENS, P_D),
        "w1": normal(P_D, P_DFF, scale=P_D ** -0.5),
        "b1": normal(P_DFF, scale=0.1),
        "w2": normal(P_DFF, P_D, scale=P_DFF ** -0.5),
        "b2": normal(P_D, scale=0.1),
        "ew1": normal(P_EXPERTS, P_D, P_DFF, scale=P_D ** -0.5),
        "ew2": normal(P_EXPERTS, P_DFF, P_D, scale=P_DFF ** -0.5),
        "logits": normal(P_TOKENS, P_EXPERTS, scale=2.0),
        "mb": normal(P_MICRO, P_MB_ROWS, P_D),
        "stages": normal(PR_WORLD, P_D, P_D, scale=P_D ** -0.5),
        "q": normal(1, P_HEADS, P_SEQ, P_HEAD_D),
        "k": normal(1, P_HEADS, P_SEQ, P_HEAD_D),
        "v": normal(1, P_HEADS, P_SEQ, P_HEAD_D),
    }


def p_gates(logits):
    z = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (z / z.sum(axis=1, keepdims=True)).astype(np.float32)


class CollectiveClock:
    """Host seconds spent in the port's collectives (each call between two
    card synchronizations), installed over :mod:`~flinkml_tpu_torch.
    parallel.collectives`' group primitives, which ``tensor.py``,
    ``ring.py`` and ``exchange.py`` call through the module."""

    NAMES = ("group_all_reduce", "group_all_gather", "group_all_to_all",
             "ppermute")

    def __init__(self, torch):
        from flinkml_tpu_torch.parallel import collectives

        self.torch, self.mod, self.seconds = torch, collectives, 0.0
        self.saved = {n: getattr(collectives, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(collectives, name, self._timed(fn))

    def _timed(self, fn):
        def run(*args, **kwargs):
            ps_sync(self.torch)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ps_sync(self.torch)
            self.seconds += time.perf_counter() - t0
            return out
        return run

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def p_rank(torch, rank, out_dir):
    """Path P on one rank: each primitive once to warm up, then once timed
    with the collectives clocked; rank 0 keeps the outputs, every rank
    their digests (the ranks must agree bit for bit)."""
    import hashlib

    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import ring as pring
    from flinkml_tpu_torch.parallel import tensor as ptensor

    inp = p_inputs()
    model, expert = DeviceMesh({"model": PR_WORLD}), DeviceMesh(
        {"expert": PR_WORLD})
    pipe, seq = DeviceMesh({"pipe": PR_WORLD}), DeviceMesh()
    cases = {
        "tensor_parallel_mlp": lambda: ptensor.tensor_parallel_mlp(
            inp["x"], inp["w1"], inp["b1"], inp["w2"], inp["b2"], model),
        "expert_parallel_ffn": lambda: ptensor.expert_parallel_ffn(
            inp["x"], p_gates(inp["logits"]), inp["ew1"], inp["ew2"],
            expert),
        "routed_expert_ffn": lambda: ptensor.routed_expert_ffn(
            inp["x"], inp["logits"], inp["ew1"], inp["ew2"], expert,
            capacity_factor=P_CAPACITY),
        "pipeline_parallel_apply": lambda: ptensor.pipeline_parallel_apply(
            inp["mb"], inp["stages"], "linear_tanh", pipe),
    }
    for causal in (False, True):
        for kind, fn in (("ring", pring.ring_attention),
                         ("ulysses", pring.ulysses_attention)):
            cases[f"{kind}_attention_causal_{causal}"] = (
                lambda fn=fn, causal=causal: fn(inp["q"], inp["k"], inp["v"],
                                                seq, causal=causal))
    out, timing = {}, {}
    for name, fn in cases.items():
        fn()  # warm-up
        clock = CollectiveClock(torch)
        try:
            secs, got = ps_seconds(torch, fn)
        finally:
            clock.close()
        host = got.float().cpu().numpy()
        out[f"p_digest_{name}"] = np.frombuffer(
            hashlib.sha256(host.tobytes()).digest(), np.uint8)
        if rank == 0:
            out[f"p_out_{name}"] = host
        timing[name] = (secs * 1e3, clock.seconds * 1e3)
        del got
    out["p_timing"] = np.asarray([timing[n] for n in cases])
    out["p_names"] = np.asarray(list(cases))
    return out


def p_references(torch, inp):
    """The same computations unsharded on the card (no mesh, no
    collective), each a function of nothing."""
    import torch.nn.functional as F

    from flinkml_tpu_torch.parallel import ring as pring
    from flinkml_tpu_torch.parallel.tensor import route_top1

    dev = PS_DEVICE

    def t(name):
        return torch.from_numpy(inp[name]).to(dev)

    def gelu(a):
        return F.gelu(a, approximate="tanh")

    def mlp():
        return gelu(t("x") @ t("w1") + t("b1")) @ t("w2") + t("b2")

    def experts(gates):
        x, w1, w2 = t("x"), t("ew1"), t("ew2")
        return sum(gates[:, e:e + 1] * (gelu(x @ w1[e]) @ w2[e])
                   for e in range(P_EXPERTS))

    def dense():
        return experts(torch.from_numpy(p_gates(inp["logits"])).to(dev))

    def routed():
        # Each rank's tokens routed on their own, with its capacity.
        n_local = P_TOKENS // PR_WORLD
        capacity = max(1, int(np.ceil(n_local * P_CAPACITY / PR_WORLD)))
        gates = torch.zeros((P_TOKENS, P_EXPERTS), device=dev)
        for r in range(PR_WORLD):
            rows = slice(r * n_local, (r + 1) * n_local)
            expert, gate, _, keep = route_top1(t("logits")[rows], capacity)
            block = torch.zeros((n_local, P_EXPERTS), device=dev)
            block[keep, expert[keep]] = gate[keep]
            gates[rows] = block
        return experts(gates)

    def pipeline():
        acts = t("mb")
        for s in range(PR_WORLD):
            acts = torch.tanh(acts @ t("stages")[s])
        return acts

    refs = {"tensor_parallel_mlp": mlp, "expert_parallel_ffn": dense,
            "routed_expert_ffn": routed, "pipeline_parallel_apply": pipeline}
    for causal in (False, True):
        for kind in ("ring", "ulysses"):
            refs[f"{kind}_attention_causal_{causal}"] = (
                lambda causal=causal: pring._full_attention(
                    t("q"), t("k"), t("v"), causal))
    return refs


def p_check(torch, outs):
    """Path P in the parent: the ranks' digests equal, rank 0's outputs
    within :data:`P_TOL` of the unsharded computation on the card."""
    inp = p_inputs()
    refs = p_references(torch, inp)
    names = [str(n) for n in outs[0]["p_names"]]
    rec = {"path": "tensor_P", "world": PR_WORLD, "backend": PR_BACKEND,
           "tokens": P_TOKENS, "d_model": P_D, "d_ff": P_DFF,
           "experts": P_EXPERTS, "capacity_factor": P_CAPACITY,
           "microbatches": [P_MICRO, P_MB_ROWS],
           "qkv": [1, P_HEADS, P_SEQ, P_HEAD_D], "tolerance": P_TOL,
           "cases": {}}
    for i, name in enumerate(names):
        for r in range(1, PR_WORLD):
            if not np.array_equal(outs[r][f"p_digest_{name}"],
                                  outs[0][f"p_digest_{name}"]):
                fail(f"path P: rank {r}'s {name} differs from rank 0's")
        refs[name]()  # warm-up (the parent's first cuBLAS call)
        ref_s, want = ps_seconds(torch, refs[name])
        got = torch.from_numpy(outs[0][f"p_out_{name}"]).to(want.device)
        err = max_err(got, want)
        scale = float(want.abs().max().item())
        if not (bool(torch.isfinite(got).all()) and err <= P_TOL * scale):
            fail(f"path P: {name} differs from the unsharded computation "
                 f"by {err} (largest magnitude {scale})")
        ms, coll_ms = (float(v) for v in outs[0]["p_timing"][i])
        rec["cases"][name] = {
            "ms": ms, "collective_ms": coll_ms,
            "collective_share": coll_ms / ms, "unsharded_ms": ref_s * 1e3,
            "max_abs_err": err, "max_abs_ref": scale,
            "ranks_bit_for_bit": True}
        del want, got
    ps_sync(torch)
    return rec


def r_table_rows():
    """The rows an ``EmbeddingTable(scale=0.01, seed=0)`` of path R holds."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((R_VOCAB, R_DIM)) * 0.01).astype(np.float32)


def r_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, R_VOCAB, R_BATCH).astype(np.int32)
    delta = (rng.normal(size=(R_BATCH, R_DIM)) * 1e-3).astype(np.float32)
    return ids, delta


def r_rates(torch, table, ids, delta, strategy):
    """Lookup and update rows/s of ``R_REPS`` calls each (host clock,
    synchronized), after one warm-up call of each; the lookups (of the
    fresh table) come back too."""
    table.lookup(ids)
    lookup_s, got = ps_seconds(torch, lambda: [table.lookup(ids)
                                               for _ in range(R_REPS)][-1])
    table.scatter_add(ids, delta, strategy=strategy)
    update_s, _ = ps_seconds(torch, lambda: [
        table.scatter_add(ids, delta, strategy=strategy)
        for _ in range(R_REPS)])
    return (R_BATCH * R_REPS / lookup_s, R_BATCH * R_REPS / update_s,
            got.cpu().numpy())


def r2_rank(torch, rank, out_dir):
    """Path R2 on one rank: the contract at :data:`R2_BUDGET` (FML503
    refuses the replicated placement, ``infer_plan`` routes past fsdp to
    the embedding plan), then each strategy's lookup and update rates, the
    lookups through ``exchange.gather`` of both strategies, and the table
    after ``1 + R_REPS`` updates; returns rank 0's results and this rank's
    ``segment_sum`` launches."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis.sharding_check import check_plan
    from flinkml_tpu_torch.embeddings import EmbeddingTable, exchange
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding import EMBEDDING, REPLICATED, infer_plan

    mesh = DeviceMesh.for_plan(EMBEDDING)
    param = {"bench/embedding": (R_VOCAB, R_DIM)}
    refusal = check_plan(REPLICATED, mesh, param_shapes=param,
                         hbm_budget_bytes=R2_BUDGET, optimizer_slots=1)
    plan = infer_plan(mesh, param, R2_BUDGET, optimizer_slots=1)
    ids, delta = r_batch()
    out = {"r2_fml503": np.asarray(any(f.rule == "FML503" for f in refusal)),
           "r2_plan": np.asarray(plan.name)}
    fml.reset_launch_counts()
    for strategy in ("ring", "all_to_all"):
        table = EmbeddingTable("bench", R_VOCAB, R_DIM, mesh=mesh, plan=plan,
                               hbm_budget_bytes=R2_BUDGET, optimizer_slots=1,
                               scale=0.01)
        lookup_rate, update_rate, looked = r_rates(torch, table, ids, delta,
                                                   strategy)
        (gathered,) = exchange.gather(
            ((table.rows, torch.from_numpy(ids).to(table.device)),),
            axes=table.axes, n_shards=table.n_shards,
            shard_rows=table.shard_rows, strategy=strategy)
        host = table.to_host()
        out[f"r2_{strategy}_rates"] = np.asarray([lookup_rate, update_rate])
        out[f"r2_{strategy}_bytes"] = np.asarray(
            table.exchange_bytes_per_step(R_BATCH, strategy))
        out[f"r2_{strategy}_shards"] = np.asarray([table.n_shards,
                                                   table.shard_rows])
        if rank == 0:
            out[f"r2_{strategy}_lookup"] = looked
            out[f"r2_{strategy}_gather"] = gathered.cpu().numpy()
            out[f"r2_{strategy}_host"] = host
        del table
    out["r2_segment_sum"] = np.asarray(fml.launch_counts()["segment_sum"])
    return out


def pr_rank(out_dir: str) -> int:
    """One rank of paths P and R2 (``chip_smoke.py --pr-rank OUT_DIR``,
    started by :func:`pr_ranks`): joins a group of ``PR_WORLD`` ranks over
    gloo with CUDA tensors on the current card, runs :func:`p_rank`,
    :func:`r2_rank`, :func:`u6_rank` and :func:`v2_rank`, and writes ``OUT_DIR/rank<r>.npz``."""
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.parallel import distributed as pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    fml.set_default_device(PS_DEVICE)
    rank, world = pdist.init_distributed(backend=PR_BACKEND, timeout_s=300)
    try:
        out = p_rank(torch, rank, out_dir)
        out.update(r2_rank(torch, rank, out_dir))
        out.update(u6_rank(torch, rank, out_dir))
        out.update(v2_rank(torch, rank, out_dir))
        from flinkml_tpu_torch.parallel.collectives import HOST_STAGED

        out["host_staged"] = np.asarray([HOST_STAGED["ppermute"],
                                         HOST_STAGED["all_to_all"]])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 rank_world=np.asarray([rank, world]), **out)
    finally:
        pdist.shutdown_distributed()
    return 0


def pr_ranks(torch):
    """Paths P, R2, U6 and V2's ranks on ``PR_WORLD`` ranks spawned here
    on the one card; returns ``(P's record, R2's record, R2's segment_sum launches,
    every rank's outputs)`` (U6's are checked by :func:`u6_check` once the
    parent's own launches have been read)."""
    import tempfile

    from flinkml_tpu_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks([sys.executable, os.path.abspath(__file__), "--pr-rank",
                     tmp], PR_WORLD, tmp, PR_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(PR_WORLD)]
    PREPARED["pr_outs"] = outs   # V2's ranks, checked in path V
    p_rec = p_check(torch, outs)
    p_rec["wall_s"] = wall_s
    p_rec["host_staged_rank0"] = dict(zip(
        ("ppermute", "all_to_all"), outs[0]["host_staged"].tolist()))
    r2_rec, launches = r2_check(outs)
    return p_rec, r2_rec, launches, outs


def r2_check(outs):
    """R2 in the parent: the contract held, the lookups bit for bit with
    the dense gather of the fresh table and each strategy's
    ``exchange.gather`` with that of the updated one, the tables within
    1e-5 of ``np.add.at`` applied ``1 + R_REPS`` times."""
    rows = r_table_rows()
    ids, delta = r_batch()
    want = rows.copy()
    for _ in range(1 + R_REPS):
        np.add.at(want, ids, delta)
    o = outs[0]
    if not bool(o["r2_fml503"]) or str(o["r2_plan"]) != "embedding":
        fail(f"path R2: FML503 {bool(o['r2_fml503'])}, plan "
             f"{str(o['r2_plan'])} at {R2_BUDGET} bytes")
    rec = {"world": PR_WORLD, "budget_bytes": R2_BUDGET,
           "plan": str(o["r2_plan"]), "fml503_refuses_replicated": True,
           "strategies": {}}
    for strategy in ("ring", "all_to_all"):
        if o[f"r2_{strategy}_lookup"].tobytes() != rows[ids].tobytes():
            fail(f"path R2: the {strategy} lookup differs from the dense "
                 "gather")
        if o[f"r2_{strategy}_gather"].tobytes() != \
                o[f"r2_{strategy}_host"][ids].tobytes():
            fail(f"path R2: exchange.gather ({strategy}) differs from the "
                 "dense gather of the updated table")
        err = float(np.abs(o[f"r2_{strategy}_host"] - want).max())
        if not err <= 1e-5:
            fail(f"path R2: the {strategy} table differs from np.add.at by "
                 f"{err}")
        rec["strategies"][strategy] = {
            "lookup_rows_per_s": [float(x[f"r2_{strategy}_rates"][0])
                                  for x in outs],
            "update_rows_per_s": [float(x[f"r2_{strategy}_rates"][1])
                                  for x in outs],
            "exchange_bytes_per_step": int(o[f"r2_{strategy}_bytes"]),
            "shards_rows": o[f"r2_{strategy}_shards"].tolist(),
            "lookup_bit_for_bit": True, "max_abs_err_vs_add_at": err}
    return rec, int(sum(int(x["r2_segment_sum"]) for x in outs))


def r_hot_spot(torch, timer, n_shards=PR_WORLD):
    """The all_to_all scatter's local ``segment_sum`` on rank 0 of R2 as
    the JAX package has it (the gathered batch, the rows another shard
    owns added as zeros into local row 0) beside the same sum with those
    rows left out: device ms of each, and the row-0 share of the cells."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    ids, delta = r_batch()
    shard_rows = -(-R_VOCAB // n_shards)
    mask = ids < shard_rows
    dev = PS_DEVICE
    vals = torch.from_numpy(np.where(mask[:, None], delta, 0)).to(dev)
    seg = torch.from_numpy(np.where(mask, ids, 0).astype(np.int32)).to(dev)
    own_vals = torch.from_numpy(delta[mask]).to(dev)
    own_seg = torch.from_numpy(ids[mask].astype(np.int32)).to(dev)
    got = segment_sum(vals, seg, shard_rows)
    want = segment_sum(own_vals, own_seg, shard_rows)
    err = max_err(got, want)
    if not err <= 1e-5:
        fail(f"path R: the masked scatter differs from the owned rows' by "
             f"{err}")
    return {"cells": int(ids.size), "masked_to_row0": int((~mask).sum()),
            "segments": shard_rows, "k": R_DIM,
            "ms_with_row0": timer(lambda: segment_sum(vals, seg, shard_rows)),
            "ms_owned_only": timer(lambda: segment_sum(own_vals, own_seg,
                                                       shard_rows)),
            "max_abs_err": err}


def r_world1(torch):
    """R1: world 1 over nccl: FML503 refuses the replicated placement at
    the bench's 24 MB and ``infer_plan`` finds no plan (every one holds
    the whole 128 MB on one rank); the table placed replicated (no
    budget): lookups bit for bit with the dense gather, the update
    (``index_add_``, the JAX package's ``.at[].add``) within 1e-5 of
    ``np.add.at``, the rates."""
    import tempfile

    from flinkml_tpu_torch.analysis.sharding_check import check_plan
    from flinkml_tpu_torch.embeddings import EmbeddingTable
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import distributed as pdist
    from flinkml_tpu_torch.sharding import (
        EMBEDDING,
        REPLICATED,
        NoFeasiblePlanError,
        infer_plan,
    )

    ids, delta = r_batch()
    rows = r_table_rows()
    with tempfile.TemporaryDirectory() as tmp:
        pdist.init_distributed("file://" + os.path.join(tmp, "store"), 1, 0,
                               backend=J1_BACKEND, timeout_s=300)
        try:
            mesh = DeviceMesh.for_plan(EMBEDDING)
            param = {"bench/embedding": (R_VOCAB, R_DIM)}
            refusal = check_plan(REPLICATED, mesh, param_shapes=param,
                                 hbm_budget_bytes=R_BUDGET, optimizer_slots=1)
            if not any(f.rule == "FML503" for f in refusal):
                fail("path R1: FML503 did not refuse the replicated table")
            try:
                infer_plan(mesh, param, R_BUDGET, optimizer_slots=1)
                fail("path R1: infer_plan found a plan for 128 MB on one "
                     "rank under 24 MB")
            except NoFeasiblePlanError:
                pass
            table = EmbeddingTable("bench", R_VOCAB, R_DIM, mesh=mesh,
                                   plan=REPLICATED, optimizer_slots=1,
                                   scale=0.01)
            lookup_rate, update_rate, looked = r_rates(torch, table, ids,
                                                       delta, None)
            host = table.to_host()
        finally:
            pdist.shutdown_distributed()
    if looked.tobytes() != rows[ids].tobytes():
        fail("path R1: the lookup differs from the dense gather")
    want = rows.copy()
    for _ in range(1 + R_REPS):
        np.add.at(want, ids, delta)
    err = float(np.abs(host - want).max())
    if not err <= 1e-5:
        fail(f"path R1: the update differs from np.add.at by {err}")
    return {"world": 1, "backend": J1_BACKEND, "budget_bytes": R_BUDGET,
            "fml503_refuses_replicated": True, "infer_plan": "no feasible plan",
            "plan_used": "replicated", "lookup_rows_per_s": lookup_rate,
            "update_rows_per_s": update_rate, "max_abs_err_vs_add_at": err,
            "lookup_bit_for_bit": True,
            "exchange_bytes_per_step": table.exchange_bytes_per_step(
                R_BATCH)}


def q_data():
    """bench.py's ``_inner_als`` ratings (seed 0)."""
    rng = np.random.default_rng(0)
    users = rng.integers(0, Q_USERS, size=Q_NNZ).astype(np.int32)
    items = rng.integers(0, Q_ITEMS, size=Q_NNZ).astype(np.int32)
    ratings = rng.uniform(1, 5, size=Q_NNZ).astype(np.float32)
    return users, items, ratings


def q_estimator(layout="segment", iters=Q_ITERS, implicit=False, **kw):
    import flinkml_tpu_torch as fml

    return fml.ALS(layout=layout, **kw).set_rank(Q_RANK).set_max_iter(
        iters).set_seed(0).set_implicit_prefs(implicit)


def numpy_half_step(users, items, ratings, check, reg=0.1):
    """The first half-step's factors of users ``check`` in float64 numpy:
    each user's normal equations from the seeded item init (ALS-WR)."""
    rng = np.random.default_rng(0)
    y = rng.normal(scale=1.0 / np.sqrt(Q_RANK),
                   size=(Q_ITEMS, Q_RANK)).astype(np.float32)
    y = y.astype(np.float64)
    out = np.zeros((len(check), Q_RANK))
    order = np.argsort(users, kind="stable")
    starts = np.searchsorted(users[order], check)
    ends = np.searchsorted(users[order], check, side="right")
    for j, (lo, hi) in enumerate(zip(starts, ends)):
        sel = order[lo:hi]
        ys = y[items[sel]]
        lam = max(reg * max(hi - lo, 1), 1e-4)
        a = ys.T @ ys + lam * np.eye(Q_RANK)
        out[j] = np.linalg.solve(a, ys.T @ ratings[sel].astype(np.float64))
    return out


def q_close(name, got, want, rtol=None, atol=None):
    rtol = Q_RTOL if rtol is None else rtol
    atol = Q_ATOL if atol is None else atol
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and np.allclose(got, want, rtol=rtol,
                                                    atol=atol)):
        fail(f"path Q: {name} differs by {err} (rtol {rtol}, atol {atol})")
    return err


#: Relative agreement of two fits' training RMSE past the first iteration.
Q_RMSE_RTOL = 1e-4


def q_rmse(model, table) -> float:
    """The model's root mean square error on its training ratings."""
    import flinkml_tpu_torch as fml

    (out,) = model.transform(fml.Table({"user": table.column("user"),
                                        "item": table.column("item")}))
    err = out.column("prediction") - table.column("rating")
    return float(np.sqrt(np.mean(err * err)))


def q_rmse_close(name, got, want):
    if not abs(got - want) <= Q_RMSE_RTOL * want:
        fail(f"path Q: {name}: training RMSE {got} against {want}")


def q_segsum_case(torch, timer, users, items, model_items):
    """The user half-step's first chunk as the kernel sees it: the
    ``[65,536, k²]`` outer products into ``users + 1`` segments, against
    its plain version, with its bound and ``index_add_``'s time."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    dev = PS_DEVICE
    n = min(1 << 16, Q_NNZ)
    y = torch.from_numpy(model_items[items[:n]]).to(dev)
    vals = (y[:, :, None] * y[:, None, :]).reshape(n, Q_RANK * Q_RANK)
    seg = torch.from_numpy(users[:n]).to(dev)
    got = ksegsum.segment_sum(vals, seg, Q_USERS + 1)
    want = ksegsum.segment_sum_plain(vals, seg, Q_USERS + 1)
    check_close("path Q segment_sum [65536, 1024]", got, want, 1e-5, 1e-5)
    n_bytes = seg.numel() * 4 + vals.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, vals.numel(), "float32")
    long_seg = seg.long()
    return {"shape": [n, Q_RANK * Q_RANK, Q_USERS + 1],
            "max_abs_err": max_err(got, want),
            "ms": timer(lambda: ksegsum.segment_sum(vals, seg, Q_USERS + 1)),
            "plain_ms": timer(lambda: ksegsum.segment_sum_plain(
                vals, seg, Q_USERS + 1)),
            "library_ms": timer(lambda: torch.zeros(
                tuple(got.shape), device=dev).index_add_(0, long_seg, vals)),
            "bound_ms": b_ms, "bound_by": b_by}


def q_topk_case(torch, timer, model):
    """``recommend_for_all_users(10)``'s selection: the ``topk`` kernel on
    the ``[users, items]`` scores against ``torch.topk``'s values, with
    its bound."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    dev = PS_DEVICE
    u = torch.from_numpy(model.user_factors.astype(np.float32)).to(dev)
    v = torch.from_numpy(model.item_factors.astype(np.float32)).to(dev)
    scores = u @ v.T
    vals, idx = ktopk.top_k(scores, 10)
    lib_vals, _ = torch.topk(scores, 10)
    if not torch.equal(vals, lib_vals):
        fail(f"path Q: topk's values differ from torch.topk's by "
             f"{max_err(vals, lib_vals)}")
    plain_vals, plain_idx = ktopk.top_k_plain(scores, 10)
    if not (torch.equal(vals, plain_vals) and torch.equal(idx, plain_idx)):
        fail("path Q: topk differs from its plain version")
    n_bytes = scores.numel() * 4 + vals.numel() * 8
    b_ms, b_by = bound_ms(n_bytes, scores.numel(), "float32")
    return {"shape": list(scores.shape), "k": 10, "max_abs_err": 0.0,
            "ms": timer(lambda: ktopk.top_k(scores, 10)),
            "plain_ms": timer(lambda: ktopk.top_k_plain(scores, 10),
                              warmup=1, iters=3),
            "library_ms": timer(lambda: torch.topk(scores, 10)),
            "bound_ms": b_ms, "bound_by": b_by}


def q_stream(torch, users, items, ratings, tmp):
    """The streamed fit from a ``DataCache`` of ``Q_STREAM_BATCHES``
    batches: uninterrupted, and crashed after its epoch-1 snapshot then
    resumed; the two fits' training RMSE within :data:`Q_RMSE_RTOL` (the
    segment layout's atomics add in a run-dependent order, and the
    second iteration spreads that into the factors)."""
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream

    per = Q_NNZ // Q_STREAM_BATCHES
    cache = cache_stream(iter([
        {"user": users[i * per:(i + 1) * per],
         "item": items[i * per:(i + 1) * per],
         "rating": ratings[i * per:(i + 1) * per]}
        for i in range(Q_STREAM_BATCHES)]))

    class Crash(CheckpointManager):
        fired = False

        def save(self, state, epoch, extra=None, **kw):
            path = super().save(state, epoch, extra, **kw)
            if not Crash.fired and epoch >= 1:
                Crash.fired = True
                raise RuntimeError("injected crash")
            return path

    secs, golden = ps_seconds(torch, lambda: q_estimator(
        iters=Q_STREAM_ITERS).fit(cache))
    mgr = Crash(os.path.join(tmp, "ckpt"))
    try:
        q_estimator(iters=Q_STREAM_ITERS, checkpoint_manager=mgr,
                    checkpoint_interval=1).fit(cache)
        fail("path Q: the streamed fit did not crash")
    except RuntimeError:
        pass
    resumed = q_estimator(iters=Q_STREAM_ITERS, checkpoint_manager=mgr,
                          checkpoint_interval=1, resume=True).fit(cache)
    import flinkml_tpu_torch as fml

    table = fml.Table({"user": users, "item": items, "rating": ratings})
    rmse = (q_rmse(resumed, table), q_rmse(golden, table))
    q_rmse_close("the resumed streamed fit", *rmse)
    return {"batches": Q_STREAM_BATCHES, "iters": Q_STREAM_ITERS,
            "seconds": secs,
            "rating_visits_per_s": Q_NNZ * 2 * Q_STREAM_ITERS / secs,
            "train_rmse_resumed_uninterrupted": list(rmse),
            "resume_max_abs_diff": float(np.abs(
                resumed.user_factors - golden.user_factors).max()),
            "resumed_from": 1}


def q_serve(torch, model):
    """``factor_tables()``, then the item factors as an
    ``EmbeddingLookupModel`` behind a ``ServingEngine`` on a one-device
    mesh: 4,096 rows of 4 ids within the ``mixed_inference`` tolerance
    (bfloat16 rows summed at bfloat16: 2^-6 of the largest factor) of
    the float32 mean."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.embeddings.serving import EmbeddingLookupModel
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.serving.engine import ServingConfig, ServingEngine

    user_t, item_t = model.factor_tables()
    if user_t.rows.device.type != PS_DEVICE:
        fail(f"path Q: factor_tables placed on {user_t.rows.device}")
    rows = item_t.to_host()
    ids = np.random.default_rng(1).integers(
        0, Q_ITEMS, size=(Q_SERVE_ROWS, Q_SERVE_IDS)).astype(np.int32)
    engine = ServingEngine(
        EmbeddingLookupModel(rows), fml.Table({"ids": ids[:2]}),
        config=ServingConfig(mesh=DeviceMesh(), max_batch_rows=Q_SERVE_ROWS))
    engine.start()
    try:
        secs, resp = ps_seconds(torch, lambda: engine.predict({"ids": ids}))
        bound = engine._active.model
    finally:
        engine.stop()
    if bound._table is None or bound._table.rows.device.type != PS_DEVICE:
        fail("path Q: the engine did not bind the lookup model to its mesh")
    got = np.asarray(resp.columns["vector"], np.float64)
    want = rows[ids].astype(np.float64).mean(axis=1)
    err = float(np.abs(got - want).max())
    tol = 2.0 ** -6 * float(np.abs(rows).max())
    if not err <= tol:
        fail(f"path Q: served vectors differ from the float32 mean by {err}")
    return {"rows": Q_SERVE_ROWS, "ids_per_row": Q_SERVE_IDS,
            "predict_s": secs, "max_abs_err_vs_float32": err,
            "tolerance": tol}


def als_path(torch, timer):
    """Path Q (``bench.py``'s ``_inner_als`` shape): module docstring.
    Returns ``(record, segment_sum launches, topk launches, kernel
    records)``."""
    import tempfile

    import flinkml_tpu_torch as fml

    users, items, ratings = q_data()
    table = fml.Table({"user": users, "item": items, "rating": ratings})
    rec = {"path": "als_Q", "users": Q_USERS, "items": Q_ITEMS,
           "nnz": Q_NNZ, "rank": Q_RANK, "iters": Q_ITERS}
    fml.reset_launch_counts()
    one_s, one = ps_seconds(torch, lambda: q_estimator(iters=1).fit(table))
    check = np.arange(Q_CHECK_USERS)
    want = numpy_half_step(users, items, ratings, check)
    err = q_close("the first half-step vs float64 numpy",
                  one.user_factors[check], want, rtol=1e-4, atol=1e-5)
    rec["half_step_max_abs_err_vs_float64"] = err
    rec["first_fit_s"] = one_s
    one_cumsum = q_estimator("cumsum", iters=1).fit(table)
    rec["layouts_max_abs_diff_1_iter"] = q_close(
        "the cumsum fit vs the segment fit (1 iteration)",
        one_cumsum.user_factors, one.user_factors)
    fits = {}
    for layout in ("segment", "cumsum"):
        secs, fits[layout] = ps_seconds(
            torch, lambda layout=layout: q_estimator(layout).fit(table))
        rec[f"{layout}_fit_s"] = secs
        rec[f"{layout}_rating_visits_per_s"] = Q_NNZ * 2 * Q_ITERS / secs
        rec[f"{layout}_train_rmse"] = q_rmse(fits[layout], table)
    # Past the first iteration two summation orders drift apart in the
    # factors (the factorization of these random ratings is far from
    # unique); the fits are held by their training error instead.
    rec["layouts_max_abs_diff"] = float(np.abs(
        fits["cumsum"].user_factors - fits["segment"].user_factors).max())
    q_rmse_close("the cumsum fit vs the segment fit",
                 rec["cumsum_train_rmse"], rec["segment_train_rmse"])
    again = q_estimator("cumsum").fit(table)
    if not np.array_equal(again.user_factors, fits["cumsum"].user_factors):
        fail("path Q: two cumsum fits on the card differ")
    rec["cumsum_bit_for_bit"] = True
    secs, implicit = ps_seconds(torch, lambda: q_estimator(
        iters=1, implicit=True).fit(table))
    if not np.isfinite(implicit.user_factors).all():
        fail("path Q: the implicit fit is not finite")
    rec["implicit_fit_s"] = secs
    with tempfile.TemporaryDirectory() as tmp:
        rec["stream"] = q_stream(torch, users, items, ratings, tmp)
    model = fits["segment"]
    secs, (rec_ids, rec_scores) = ps_seconds(
        torch, lambda: model.recommend_for_all_users(10))
    if rec_ids.shape != (Q_USERS, 10) or not np.all(
            np.diff(rec_scores, axis=1) <= 0):
        fail("path Q: recommend_for_all_users is not [users, 10] descending")
    rec["recommend_s"] = secs
    rec["serve"] = q_serve(torch, model)
    counts = fml.launch_counts()
    seg_n, topk_n = counts["segment_sum"], counts["topk"]
    if not seg_n or not topk_n:
        fail(f"path Q: segment_sum {seg_n} / topk {topk_n} launches")
    # The CPU port's fit of one iteration (plain segment_sum: index_add_
    # in cell order) beside the card's, on the first Q_CPU_NNZ ratings.
    head = fml.Table({"user": users[:Q_CPU_NNZ], "item": items[:Q_CPU_NNZ],
                      "rating": ratings[:Q_CPU_NNZ]})
    card = q_estimator(iters=1).fit(head)
    t0 = time.perf_counter()
    with fml.use_device("cpu"):
        cpu = q_estimator(iters=1).fit(head)
    rec["cpu_fit_s"] = time.perf_counter() - t0
    rec["cpu_check_nnz"] = Q_CPU_NNZ
    rec["card_vs_cpu_max_abs_diff"] = {
        "user": q_close("the card fit vs the CPU fit (users)",
                        card.user_factors, cpu.user_factors),
        "item": q_close("the card fit vs the CPU fit (items)",
                        card.item_factors, cpu.item_factors)}
    kernels = {"segment_sum": q_segsum_case(torch, timer, users, items,
                                            one.item_factors.astype(
                                                np.float32)),
               "topk": q_topk_case(torch, timer, model)}
    rec["launches"] = {"segment_sum": seg_n, "topk": topk_n}
    rec["card"] = card_line()
    log("path " + json.dumps(rec))
    for name, k in kernels.items():
        log(f"kernel {name} als_Q " + json.dumps(k))
    return seg_n, topk_n, kernels


def s_batch(rng):
    from flinkml_tpu_torch.features import hash_buckets

    keys = rng.integers(0, 1 << 22, size=(S_ROWS, S_LEN))
    ids = hash_buckets(keys.reshape(-1), seed=7,
                       num_buckets=S_BUCKETS).reshape(S_ROWS, S_LEN)
    return ids, (keys.sum(axis=1) % 2).astype(np.float32)


def features_path(torch):
    """Path S (``bench.py``'s ``_feature_freshness_stage`` shape): module
    docstring. Returns the record."""
    import tempfile

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.features import (
        DeltaPublisher,
        StreamingHashedFMTrainer,
    )
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.serving.engine import ServingConfig
    from flinkml_tpu_torch.serving.pool import ReplicaPool
    from flinkml_tpu_torch.serving.registry import ModelRegistry
    from flinkml_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(0)
    trainer = StreamingHashedFMTrainer(num_buckets=S_BUCKETS,
                                       factor_size=S_FACTOR, hash_seed=7,
                                       learning_rate=0.05)
    if trainer._v_table.rows.device.type != PS_DEVICE:
        fail("path S: the trainer's tables are not on the card")
    example = fml.Table({"hashed_ids": np.zeros((2, S_LEN), np.int32)})
    with tempfile.TemporaryDirectory() as root:
        registry = ModelRegistry(os.path.join(root, "reg"))
        publisher = DeltaPublisher(registry, trainer, every_n_batches=1,
                                   max_depth=S_PUBLISHES + 1,
                                   name="smoke_freshness")
        trainer.fit_batch(*s_batch(rng))
        publisher.publish_now()
        pool = ReplicaPool(
            registry, example,
            config=ServingConfig(max_batch_rows=256, max_wait_ms=1.0),
            meshes=[DeviceMesh(), DeviceMesh()], name="smoke_freshness",
        ).start().follow_registry()
        try:
            t_train, fresh_ms, checked = 0.0, [], 0
            probe = s_batch(np.random.default_rng(1))[0][:64]
            for _ in range(S_PUBLISHES):
                ids, labels = s_batch(rng)
                secs, _ = ps_seconds(torch, lambda: trainer.fit_batch(
                    ids, labels))
                t_train += secs
                t0 = time.perf_counter()
                version = publisher.publish_now()
                fresh_ms.append((time.perf_counter() - t0) * 1e3)
                resp = pool.predict({"hashed_ids": probe})
                (want,) = registry.get(resp.version)[1].transform(
                    fml.Table({"hashed_ids": probe}))
                for col in ("prediction", "rawPrediction"):
                    if resp.column(col).tobytes() != np.asarray(
                            want.column(col)).tobytes():
                        fail(f"path S: version {resp.version}'s {col} "
                             "differs from its full snapshot")
                checked += resp.version == version
            lag = pool.freshness_lag(trainer.watermark)
            swaps = [r.engine._metrics.snapshot()["counters"].get(
                "delta_swaps", 0) for r in pool.replicas]
            bound = [r.engine._active.model._v_table for r in pool.replicas]
        finally:
            pool.stop()
        counters = registry._metrics.snapshot()["counters"]
    if lag != 0 or min(swaps) != S_PUBLISHES:
        fail(f"path S: lag {lag}, delta swaps {swaps}")
    if any(t is None or t.rows.device.type != PS_DEVICE for t in bound):
        fail("path S: a replica does not serve from tables on the card")
    gauges = metrics.group("features.publisher", labels={
        "publisher": "smoke_freshness"}).snapshot()["gauges"]
    rec = {"path": "features_S", "buckets": S_BUCKETS, "rows": S_ROWS,
           "ids_per_row": S_LEN, "factor": S_FACTOR,
           "publishes": S_PUBLISHES,
           "train_rows_per_s": S_ROWS * S_PUBLISHES / t_train,
           "delta_publishes": int(counters.get("delta_publishes", 0)),
           "delta_bytes": int(gauges["delta_bytes"]),
           "full_snapshot_bytes": int(gauges["full_bytes"]),
           "delta_ratio": float(gauges["delta_ratio"]),
           "time_to_freshness_ms_p50": float(np.percentile(fresh_ms, 50)),
           "time_to_freshness_ms_p99": float(np.percentile(fresh_ms, 99)),
           "delta_swaps": swaps, "responses_of_newest_version": int(checked),
           "bit_for_bit_with_full_snapshots": True, "card": card_line()}
    log("path " + json.dumps(rec))
    return rec


def slice_pqrs_path(torch, timer):
    """Paths P, Q, R and S (module docstring), each with the launch
    counters set to 0 before it and read after, and U6 in P-R's ranks.
    Returns ``(segment_sum launches by path, topk launches of Q, Q's
    kernel records, (U6's record, U6's segment_sum launches))``."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    fml.reset_launch_counts()
    p_rec, r2_rec, r2_segsum, rank_outs = pr_ranks(torch)
    parent = fml.launch_counts()
    if any(parent.values()):
        fail(f"path P: the parent launched kernels {parent}")
    u6 = u6_check(torch, rank_outs)
    p_rec["card"] = card_line()
    log("path " + json.dumps(p_rec))
    q_segsum, q_topk, q_kernels = als_path(torch, timer)
    fml.reset_launch_counts()
    r1 = r_world1(torch)
    r_segsum = r2_segsum + fml.launch_counts()["segment_sum"]
    if not r2_segsum:
        fail("path R: the all_to_all scatter never launched segment_sum")
    r_rec = {"path": "embeddings_R", "vocab": R_VOCAB, "dim": R_DIM,
             "batch": R_BATCH, "reps": R_REPS, "R1": r1, "R2": r2_rec,
             "segment_sum_launches": r_segsum,
             "a2a_hot_spot": r_hot_spot(torch, timer), "card": card_line()}
    log("path " + json.dumps(r_rec))
    fml.reset_launch_counts()
    features_path(torch)
    log(f"paths P-S: {time.perf_counter() - t0:.1f} s")
    return ({"als_Q": q_segsum, "embeddings_R": r_segsum}, q_topk,
            q_kernels, u6)


# -- path U: Word2Vec, FM, MLP and the text features (item 9b) ---------------

#: Path U's device (a rehearsal on the CPU sets "cpu").
U_DEVICE = "cuda"
# U1: bench.py's _inner_word2vec shape (seed 0, uniform random pairs).
U_VOCAB, U_DIM, U_PAIRS, U_BATCH, U_NEG = 32_768, 128, 1 << 20, 8_192, 5
U_STEPS, U_POOL, U_LR, U_CHECK_STEPS = 200, 1 << 17, 0.025, 5
#: The Word2Vec checks' start: both tables 0.1 * normal and lr 64 (the
#: step is lr over the batch's weight), so a row moves about 1e-2 in
#: U_CHECK_STEPS steps. From bench.py's start (u0 = 0, lr 0.025) u stays
#: near 1e-8 and v does not leave v0 in float32: no fault would show.
U_CHECK_LR = 64.0
#: The Zipf corpus of U1's end-to-end fit: about 2^20 pairs (window 5).
U_ZIPF_TOKENS, U_DOC_LEN = 180_000, 20
#: U2: a9a's width (make_data), k = 8, 200 Adam steps; the float64 sparse
#: model at Criteo's shape.
U_FM_ROWS, U_FM_D, U_FM_K, U_FM_STEPS = 1_000_000, 123, 8, 200
U_FM_BATCH, U_FM_LR = 262_144, 0.05
U_FM_SPARSE_ROWS, U_FM_SHARDED_STEPS = 262_144, 20
#: U3: MNIST's width, layers [784, 128, 10].
U_MLP_ROWS, U_MLP_STEPS, U_MLP_BATCH, U_MLP_LR = 60_000, 200, 1_024, 0.01
#: Accuracy above chance by the JAX test's margin (test_mlp_multiclass:
#: 0.97 on 3 classes).
U_MLP_MARGIN = 0.97 - 1.0 / 3.0
#: U4: short seeded documents through Tokenizer -> HashingTF -> IDF -> LR.
U_DOCS, U_HASH_DIM, U_TEXT_STEPS = 100_000, 1 << 18, 20
#: U5: the streams, 2 epochs each with a checkpoint at 1; the streamed
#: Word2Vec at a learning rate that moves its vectors in epoch 2.
U_STREAM_BATCHES, U_FM_STREAM_ROWS, U5_W2V_LR = 4, 65_536, 2.5
#: U6: the sharded Word2Vec inside P-R's two ranks.
U6_VOCAB, U6_STEPS = (1 << 18) + 1, 20
#: Card against the CPU port (first steps) and the resumes' tolerance.
U_TOL = 1e-5
#: Word2Vec's tables against their reference: the updates (table - start)
#: within this share of the largest update (the card's float32 sums part
#: by 3e-6 of it in U1's 5 steps, 2e-5 in U6's 20).
U_UPDATE_TOL = 1e-4


def u_sync(torch):
    if U_DEVICE == "cuda":
        torch.cuda.synchronize()


def u_seconds(torch, fn):
    """``(seconds, result)`` of one call, synchronized on the card."""
    u_sync(torch)
    t0 = time.perf_counter()
    out = fn()
    u_sync(torch)
    return time.perf_counter() - t0, out


def u_close(name, got, want, tol=U_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if got.shape != want.shape or not np.isfinite(got).all() \
            or not np.allclose(got, want, rtol=tol, atol=tol):
        fail(f"path U: {name} differs by {err} (tolerance {tol})")
    return err


def u_close_updates(name, got, want, start, tol=U_UPDATE_TOL):
    """Hold the update ``got - start`` against ``want - start`` within
    ``tol`` of the largest update, so that a table which stays at
    ``start`` cannot pass. Returns ``[max abs error, largest update]``."""
    start = np.asarray(start, np.float64)
    d_got = np.asarray(got, np.float64) - start
    d_want = np.asarray(want, np.float64) - start
    scale = float(np.abs(d_want).max())
    err = float(np.abs(d_got - d_want).max())
    if not (np.isfinite(d_got).all() and scale > 0 and err <= tol * scale):
        fail(f"path U: {name}'s update differs by {err} (largest update "
             f"{scale}, tolerance {tol} of it)")
    return [err, scale]


def u_check_tables(vocab, seed):
    """The Word2Vec checks' starting tables (:data:`U_CHECK_LR`)."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(vocab, U_DIM)) * 0.1).astype(np.float32)
                 for _ in range(2))


def u_w2v_data():
    """U1's pairs, pool and tables (bench.py's _inner_word2vec, seed 0)."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, U_VOCAB, size=U_PAIRS).astype(np.int32)
    contexts = rng.integers(0, U_VOCAB, size=U_PAIRS).astype(np.int32)
    pool = rng.integers(0, U_VOCAB, size=U_POOL).astype(np.int32)
    v0 = (rng.random((U_VOCAB, U_DIM)) - 0.5).astype(np.float32) / U_DIM
    u0 = np.zeros((U_VOCAB, U_DIM), np.float32)
    return centers, contexts, pool, v0, u0


def u_w2v_run(torch, data, steps, device, lr=U_LR):
    """``steps`` of the port's ``_sgns_trainer`` on ``device`` from U1's
    data: ``(v, u)``."""
    from flinkml_tpu_torch.models import word2vec as w2v
    from flinkml_tpu_torch.ops import threefry

    centers, contexts, pool, v0, u0 = data
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    trainer = w2v._sgns_trainer(None, U_BATCH, U_NEG, "scatter")
    return trainer(put(centers), put(contexts),
                   torch.ones(U_PAIRS, device=device), put(pool), put(v0),
                   put(u0), lr, steps, threefry.PRNGKey(0, device))


def zipf_docs(seed=0):
    """Token documents whose words follow Zipf's law over U1's vocab."""
    n_tokens = U_ZIPF_TOKENS
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, U_VOCAB + 1)
    ids = rng.choice(U_VOCAB, size=n_tokens, p=p / p.sum())
    words = np.asarray([f"w{i}" for i in range(U_VOCAB)], dtype=object)
    docs = np.empty(n_tokens // U_DOC_LEN, dtype=object)
    for i in range(docs.size):
        docs[i] = list(words[ids[i * U_DOC_LEN:(i + 1) * U_DOC_LEN]])
    return docs


def u_word2vec(**kw):
    import flinkml_tpu_torch as fml

    return fml.Word2Vec(**kw).set_input_col("tokens").set_vector_size(
        U_DIM).set_batch_size(U_BATCH).set_num_negatives(U_NEG) \
        .set_min_count(1).set_window_size(5).set_learning_rate(U_LR) \
        .set_seed(0)


def u_zipf_pool(docs):
    """The unigram^0.75 pool of ``docs`` as ``Word2Vec.fit`` draws it."""
    counts = {}
    for toks in docs:
        for t in toks:
            counts[t] = counts.get(t, 0) + 1
    vocab = sorted(counts, key=lambda t: (-counts[t], t))
    freq = np.asarray([counts[t] for t in vocab], np.float64) ** 0.75
    rng = np.random.default_rng(1)
    return rng.choice(len(vocab), size=1 << 18, p=freq / freq.sum()) \
        .astype(np.int32), len(vocab)


def u_segsum_case(torch, timer, label, ids, dim, segments, seed=0):
    """``segment_sum`` of ``[len(ids), dim]`` float32 rows into
    ``segments``: against its plain version on the card, with its bound
    and ``index_add_``'s time."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    dev = U_DEVICE
    vals = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(ids.size, dim)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(ids.astype(np.int32)).to(dev)
    got = ksegsum.segment_sum(vals, seg, segments)
    want = ksegsum.segment_sum_plain(vals, seg, segments)
    # A float32 sum's rounding grows with the sum of its terms' magnitudes:
    # a hot segment of the Zipf pool adds thousands of rows.
    scale = float(ksegsum.segment_sum_plain(vals.abs(), seg, segments).max())
    check_close(f"path U segment_sum {label}", got, want, 1e-5,
                1e-6 * scale)
    n_bytes = seg.numel() * 4 + vals.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, vals.numel(), "float32")
    long_seg = seg.long()
    counts = np.bincount(ids, minlength=segments)
    return {"label": label, "shape": [int(ids.size), dim, segments],
            "max_ids_on_one_segment": int(counts.max()),
            "max_abs_err": max_err(got, want),
            "ms": timer(lambda: ksegsum.segment_sum(vals, seg, segments)),
            "plain_ms": timer(lambda: ksegsum.segment_sum_plain(
                vals, seg, segments)),
            "library_ms": timer(lambda: torch.zeros(
                tuple(got.shape), device=dev).index_add_(0, long_seg, vals)),
            "bound_ms": b_ms, "bound_by": b_by}


def u1_word2vec(torch, rec):
    """U1: the trainer at bench.py's shape (card against the CPU port for
    the first steps from the checks' start, pairs/s over 200 from
    bench.py's), ``Word2Vec.fit`` on a Zipf corpus and ``find_synonyms``;
    returns ``(trained v, Zipf docs)``."""
    data = u_w2v_data()
    check = data[:3] + u_check_tables(U_VOCAB, 4)
    card = u_w2v_run(torch, check, U_CHECK_STEPS, U_DEVICE, U_CHECK_LR)
    cpu = u_w2v_run(torch, check, U_CHECK_STEPS, "cpu", U_CHECK_LR)
    rec["u1_first_steps_update_err_vs_cpu"] = {
        name: u_close_updates(
            f"U1 {name} after {U_CHECK_STEPS} steps vs the CPU port",
            a.cpu().numpy(), b.numpy(), start)
        for name, a, b, start in zip(("v", "u"), card, cpu, check[3:])}
    secs, (v, _) = u_seconds(torch, lambda: u_w2v_run(
        torch, data, U_STEPS, U_DEVICE))
    if not bool(torch.isfinite(v).all()):
        fail("path U: U1's vectors are not finite")
    rec["u1_pairs_per_s"] = U_BATCH * U_STEPS / secs
    rec["u1_seconds"] = secs
    docs = zipf_docs()
    import flinkml_tpu_torch as fml

    secs, model = u_seconds(torch, lambda: u_word2vec().set_max_iter(1).fit(
        fml.Table({"tokens": docs})))
    if not np.isfinite(model.vectors).all():
        fail("path U: the Zipf fit's vectors are not finite")
    rec["u1_zipf_fit_s"] = secs
    rec["u1_zipf_vocab"] = int(len(model.vocabulary))
    words, sims = model.find_synonyms(str(model.vocabulary[0]), 10)
    vecs = torch.from_numpy(model.vectors.astype(np.float32)).to(U_DEVICE)
    from flinkml_tpu_torch.models.word2vec import cosine_scores

    lib_vals, _ = torch.topk(cosine_scores(vecs, 0), 10)
    if not np.array_equal(sims, lib_vals.cpu().numpy()):
        fail("path U: find_synonyms' scores differ from torch.topk's")
    rec["u1_synonyms_of_top_word"] = [str(w) for w in words[:3]]
    return v, docs


def u_fm(cls, **kw):
    return cls(**kw).set_factor_size(U_FM_K).set_global_batch_size(
        U_FM_BATCH).set_learning_rate(U_FM_LR).set_tol(0.0).set_seed(0)


def u2_fm(torch, rec):
    """U2: FMClassifier at a9a's width (the first step card against CPU,
    200 steps checked on accuracy), the sharded factor fit at world 1
    (its first steps against the replicated fit's, its long fit on
    predictions), and a float64 model's sparse margin on Criteo-shaped
    rows; returns the margin's ``spmv`` operands."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.sharding import EMBEDDING

    x, y, _ = make_data(U_FM_ROWS, U_FM_D, seed=5)
    table = fml.Table({"features": x, "label": y})
    card = u_fm(fml.FMClassifier).set_max_iter(1).fit(table)
    with fml.use_device("cpu"):
        cpu = u_fm(fml.FMClassifier).set_max_iter(1).fit(table)
    rec["u2_first_step_max_abs_diff_vs_cpu"] = max(
        u_close("U2's first step vs the CPU port (w)", card._w, cpu._w),
        u_close("U2's first step vs the CPU port (v)", card._v, cpu._v))
    secs, model = u_seconds(torch, lambda: u_fm(fml.FMClassifier)
                            .set_max_iter(U_FM_STEPS).fit(table))
    acc = float((model.transform(fml.Table({"features": x}))[0]
                 .column("prediction") == y).mean())
    if not acc > 0.9:
        fail(f"path U: FMClassifier's training accuracy {acc}")
    rec["u2_fit_s"] = secs
    rec["u2_steps_per_s"] = U_FM_STEPS / secs
    rec["u2_samples_per_s"] = U_FM_STEPS * U_FM_BATCH / secs
    rec["u2_accuracy"] = acc
    head = fml.Table({"features": x[:U_FM_SPARSE_ROWS],
                      "label": y[:U_FM_SPARSE_ROWS]})
    first = [u_fm(fml.FMClassifier, **kw).set_max_iter(U_CHECK_STEPS)
             .fit(head) for kw in ({"sharding_plan": EMBEDDING}, {})]
    rec["u2_sharded_first_steps_max_abs_diff"] = max(
        u_close(f"U2's sharded fit after {U_CHECK_STEPS} steps vs the "
                f"replicated one ({name})", getattr(first[0], name),
                getattr(first[1], name)) for name in ("_w0", "_w", "_v"))
    secs, sharded = u_seconds(torch, lambda: u_fm(
        fml.FMClassifier, sharding_plan=EMBEDDING).set_max_iter(
            U_FM_SHARDED_STEPS).fit(head))
    replicated = u_fm(fml.FMClassifier).set_max_iter(
        U_FM_SHARDED_STEPS).fit(head)
    pred = [m.transform(fml.Table({"features": x[:U_FM_SPARSE_ROWS]}))[0]
            .column("prediction") for m in (sharded, replicated)]
    agree = float((pred[0] == pred[1]).mean())
    if not agree >= 0.99:
        fail(f"path U: the sharded FM fit agrees with the replicated one "
             f"on {agree} of the rows")
    rec["u2_sharded_fit_s"] = secs
    rec["u2_sharded_agreement"] = agree
    # The float64 sparse margin: w [1e6], v [1e6, 8], Criteo rows x 39.
    _, indices, values, _, _ = make_criteo_csr(U_FM_SPARSE_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=7)
    rows = criteo_rows(indices, values, U_FM_SPARSE_ROWS, SPMV_NNZ, SPMV_DIM)
    rng = np.random.default_rng(8)
    fm64 = fml.FMRegressorModel()
    fm64._set(0.5, rng.normal(size=SPMV_DIM) * 0.1,
              rng.normal(size=(SPMV_DIM, U_FM_K)) * 0.1)
    secs, got = u_seconds(torch, lambda: fm64._margin(
        fml.Table({"features": rows})))
    from flinkml_tpu_torch.ops.sparse import BatchedCSR

    ib, vb, _ = BatchedCSR.pack_sparse_vectors(rows, dtype=np.float64)
    gathered = fm64._v[ib]
    xv = np.einsum("ns,nsk->nk", vb, gathered)
    x2v2 = np.einsum("ns,nsk->nk", vb * vb, gathered * gathered)
    want = fm64._w0 + (vb * fm64._w[ib]).sum(axis=1) \
        + 0.5 * (xv * xv - x2v2).sum(axis=1)
    rec["u2_sparse_margin_max_abs_err_vs_float64"] = u_close(
        "the float64 sparse margin vs numpy", got, want, 1e-10)
    rec["u2_sparse_margin_s"] = secs
    return ib, vb, fm64._w


def u_spmv_case(torch, timer, ib, vb, w_host):
    """``spmv`` in float64 at the sparse margin's shape, against its plain
    version and ``torch.mv`` of a CSR tensor, with its bound."""
    from flinkml_tpu_torch.kernels import spmv as kspmv

    dev = U_DEVICE
    idx = torch.from_numpy(ib).to(dev)
    val = torch.from_numpy(vb).to(dev)
    w = torch.from_numpy(np.asarray(w_host, np.float64)).to(dev)
    got = kspmv.spmv(idx, val, w)
    want = kspmv.spmv_plain(idx, val, w)
    check_close("path U spmv float64", got, want, 1e-12, 1e-12)
    rows, width = ib.shape
    indptr = torch.arange(0, rows * width + 1, width, device=dev)
    csr = torch.sparse_csr_tensor(indptr, idx.reshape(-1).long(),
                                  val.reshape(-1), size=(rows, w.numel()))
    touched = np.unique(ib).size
    n_bytes = idx.numel() * 4 + val.numel() * 8 + touched * 8 + rows * 8
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "float64")
    return {"shape": [rows, width, int(w.numel())], "dtype": "float64",
            "max_abs_err": max_err(got, want),
            "ms": timer(lambda: kspmv.spmv(idx, val, w)),
            "plain_ms": timer(lambda: kspmv.spmv_plain(idx, val, w)),
            "library_ms": timer(lambda: torch.mv(csr, w)),
            "library_call": "torch.mv(sparse_csr_tensor, w)",
            "bound_ms": b_ms, "bound_by": b_by}


def u3_mlp(torch, rec):
    """U3: MLPClassifier [784, 128, 10] on MNIST-width rows (intensities
    scaled to [0, 1]), the first step card against CPU, 200 steps."""
    import flinkml_tpu_torch as fml

    x, y = mnist_like(U_MLP_ROWS, seed=3)
    x = x / np.float32(255.0)
    table = fml.Table({"features": x, "label": y})

    def est():
        return fml.MLPClassifier().set_layers([MNIST_D, 128, MNIST_K]) \
            .set_global_batch_size(U_MLP_BATCH).set_learning_rate(U_MLP_LR) \
            .set_tol(0.0).set_seed(0)

    card = est().set_max_iter(1).fit(table)
    with fml.use_device("cpu"):
        cpu = est().set_max_iter(1).fit(table)
    rec["u3_first_step_max_abs_diff_vs_cpu"] = max(
        u_close(f"U3's first step vs the CPU port (array {i})", a, b)
        for i, (a, b) in enumerate(zip(card._weights, cpu._weights)))
    secs, model = u_seconds(torch, lambda: est().set_max_iter(
        U_MLP_STEPS).fit(table))
    acc = float((model.transform(fml.Table({"features": x}))[0]
                 .column("prediction") == y).mean())
    if not acc > 1.0 / MNIST_K + U_MLP_MARGIN:
        fail(f"path U: MLPClassifier's training accuracy {acc}")
    rec["u3_fit_s"] = secs
    rec["u3_samples_per_s"] = U_MLP_STEPS * U_MLP_BATCH / secs
    rec["u3_accuracy"] = acc


def u_text_docs(seed=0):
    """Short seeded reviews: three sentiment words and seven fillers."""
    n = U_DOCS
    rng = np.random.default_rng(seed)
    pos = np.asarray(["good", "great", "excellent", "love"])
    neg = np.asarray(["bad", "awful", "terrible", "hate"])
    filler = np.asarray([f"f{i}" for i in range(2_000)])
    y = rng.integers(0, 2, size=n)
    docs = np.empty(n, dtype=object)
    for i in range(n):
        words = list(rng.choice(pos if y[i] else neg, 3)) \
            + list(rng.choice(filler, 7))
        rng.shuffle(words)
        docs[i] = " ".join(words)
    return docs.astype(str), y.astype(np.float64)


def u4_text(torch, rec):
    """U4: Tokenizer -> HashingTF(2^18) -> IDF -> LogisticRegression on
    100,000 documents; the card's coefficients against the float64 numpy
    run of the same full-batch steps on the pipeline's TF-IDF rows (1e-4
    of the largest coefficient, as path 6)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    docs, y = u_text_docs()
    table = fml.Table({"text": docs, "label": y})

    def pipe():
        return fml.Pipeline([
            fml.Tokenizer().set_input_col("text").set_output_col("tok"),
            fml.HashingTF().set_input_col("tok").set_output_col("tf")
            .set_num_features(U_HASH_DIM),
            fml.IDF().set_input_col("tf").set_output_col("features"),
            fml.LogisticRegression().set_max_iter(U_TEXT_STEPS)
            .set_global_batch_size(U_DOCS).set_learning_rate(1.0)
            .set_tol(0.0).set_seed(0)])

    secs, model = u_seconds(torch, lambda: pipe().fit(table))
    (out,) = model.transform(table)
    indptr, indices, values, dim, ys, ws = labeled_sparse_data(
        out, "features", "label")
    ref = numpy_sparse_fit(indptr, indices, values, dim, ys, ws,
                           U_TEXT_STEPS, 1.0)
    err = float(np.abs(model.stages[3].coefficient - ref).max())
    if not err <= 1e-4 * np.abs(ref).max():
        fail(f"path U: the text LR's coefficients differ from float64 numpy "
             f"by {err}")
    rec["u4_coef_max_abs_err_vs_float64"] = [err, float(np.abs(ref).max())]
    acc = float((out.column("prediction") == y).mean())
    if not acc > 0.95:
        fail(f"path U: the text pipeline's accuracy {acc}")
    rec["u4_fit_s"] = secs
    rec["u4_docs_per_s"] = U_DOCS / secs
    rec["u4_accuracy"] = acc


def u_resume(name, fit, tmp):
    """``fit(**kw)`` uninterrupted, killed by the faults module just after
    its epoch-1 snapshot commits, then resumed: ``(seconds, uninterrupted,
    resumed, the snapshot's manager)``."""
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager

    t0 = time.perf_counter()
    golden = fit()
    secs = time.perf_counter() - t0
    ckpt = CheckpointManager(os.path.join(tmp, name))
    with faults.armed(faults.FaultPlan(faults.KillAfterCheckpoint(1))):
        try:
            fit(checkpoint_manager=ckpt, checkpoint_interval=1)
            fail(f"path U: the streamed {name} fit did not crash")
        except faults.FaultInjected:
            pass
    resumed = fit(checkpoint_manager=ckpt, checkpoint_interval=1,
                  resume=True)
    return secs, golden, resumed, ckpt


def u5_streams(torch, rec, docs):
    """U5: the streamed Word2Vec and FM fits, 2 epochs, each crashed after
    its epoch-1 snapshot and resumed."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration.datacache import cache_stream

    per = docs.size // U_STREAM_BATCHES
    batches = [docs[i * per:(i + 1) * per] for i in range(U_STREAM_BATCHES)]
    with tempfile.TemporaryDirectory() as tmp:
        secs, golden, resumed, ckpt = u_resume(
            "w2v", lambda **kw: u_word2vec(**kw).set_max_iter(2)
            .set_learning_rate(U5_W2V_LR).fit(
                iter(fml.Table({"tokens": b}) for b in batches)), tmp)
        rec["u5_w2v_fit_s"] = secs
        # Epoch 2's update from the epoch-1 snapshot: a resume that skips
        # the epoch, or starts over, moves the vectors by another amount.
        like = (np.zeros(golden.vectors.shape, np.float32),) * 2
        (v1, _), _ = ckpt.restore(1, like)
        rec["u5_w2v_resume_update_err"] = u_close_updates(
            "the resumed streamed Word2Vec's epoch 2", resumed.vectors,
            golden.vectors, v1)
        x, y, _ = make_data(U_STREAM_BATCHES * U_FM_STREAM_ROWS, U_FM_D,
                            seed=9)
        cache = cache_stream(iter([
            {"x": x[i * U_FM_STREAM_ROWS:(i + 1) * U_FM_STREAM_ROWS],
             "y": y[i * U_FM_STREAM_ROWS:(i + 1) * U_FM_STREAM_ROWS]}
            for i in range(U_STREAM_BATCHES)]))
        secs, golden, resumed, _ = u_resume(
            "fm", lambda **kw: u_fm(fml.FMClassifier, **kw)
            .set_global_batch_size(8_192).set_max_iter(2).fit(cache), tmp)
        rec["u5_fm_fit_s"] = secs
        rec["u5_fm_resume_max_abs_diff"] = max(
            u_close("the resumed streamed FM (v)", resumed._v, golden._v),
            u_close("the resumed streamed FM (w)", resumed._w, golden._w))
        rec["u5_fm_resume_bit_for_bit"] = bool(
            np.array_equal(resumed._v, golden._v))


def u_topk_case(torch, timer, v):
    """``find_synonyms``' selection on U1's trained vectors: the ``topk``
    kernel on the ``[32,768]`` cosine scores, k = 10, against its plain
    version and ``torch.topk``."""
    from flinkml_tpu_torch.kernels import topk as ktopk
    from flinkml_tpu_torch.models.word2vec import cosine_scores

    sims = cosine_scores(v, 0)
    vals, idx = ktopk.top_k(sims, 10)
    plain_vals, plain_idx = ktopk.top_k_plain(sims, 10)
    if not (torch.equal(vals, plain_vals) and torch.equal(idx, plain_idx)):
        fail("path U: topk differs from its plain version")
    lib_vals, _ = torch.topk(sims, 10)
    if not torch.equal(vals, lib_vals):
        fail("path U: topk's values differ from torch.topk's")
    n_bytes = sims.numel() * 4 + 10 * 8
    b_ms, b_by = bound_ms(n_bytes, sims.numel(), "float32")
    return {"shape": [1, int(sims.numel())], "k": 10, "max_abs_err": 0.0,
            "ms": timer(lambda: ktopk.top_k(sims, 10)),
            "plain_ms": timer(lambda: ktopk.top_k_plain(sims, 10)),
            "library_ms": timer(lambda: torch.topk(sims, 10)),
            "bound_ms": b_ms, "bound_by": b_by}


def u6_data():
    """U6's pairs, pool and the checks' starting tables (vocab 2^18 + 1,
    :data:`U_CHECK_LR`)."""
    rng = np.random.default_rng(6)
    centers = rng.integers(0, U6_VOCAB, size=U_PAIRS).astype(np.int32)
    contexts = rng.integers(0, U6_VOCAB, size=U_PAIRS).astype(np.int32)
    pool = rng.integers(0, U6_VOCAB, size=U_POOL).astype(np.int32)
    return (centers, contexts, pool) + u_check_tables(U6_VOCAB, 7)


def u6_rank(torch, rank, out_dir):
    """U6 on one rank of P-R's group: the vocab-sharded SGNS trainer
    under each exchange strategy, ``U6_STEPS`` steps; the gathered tables
    of rank 0 and this rank's ``segment_sum`` launches."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models.word2vec import _sgns_trainer_sharded
    from flinkml_tpu_torch.ops import threefry
    from flinkml_tpu_torch.parallel import DeviceMesh

    mesh = DeviceMesh()
    p = mesh.axis_size()
    shard_rows = -(-U6_VOCAB // p)
    centers, contexts, pool, v0, u0 = u6_data()
    pad = np.zeros((shard_rows * p - U6_VOCAB, U_DIM), np.float32)
    v_full = np.concatenate([v0, pad])
    u_full = np.concatenate([u0, pad])
    out = {}
    fml.reset_launch_counts()
    for strategy in ("ring", "all_to_all"):
        trainer = _sgns_trainer_sharded(mesh, U_BATCH // p, U_NEG,
                                        shard_rows, strategy)
        t0 = time.perf_counter()
        v, u = trainer(mesh.shard_batch(centers), mesh.shard_batch(contexts),
                       mesh.shard_batch(np.ones(U_PAIRS, np.float32)),
                       torch.from_numpy(pool).to(mesh.device),
                       mesh.shard_batch(v_full), mesh.shard_batch(u_full),
                       U_CHECK_LR, U6_STEPS, threefry.PRNGKey(0, mesh.device))
        u_sync(torch)
        out[f"u6_{strategy}_s"] = np.asarray(time.perf_counter() - t0)
        v_host, u_host = mesh.to_host(v), mesh.to_host(u)
        if rank == 0:
            out[f"u6_{strategy}_v"] = v_host[:U6_VOCAB]
            out[f"u6_{strategy}_u"] = u_host[:U6_VOCAB]
        out[f"u6_{strategy}_digest"] = np.asarray(
            [float(np.abs(v_host).sum()), float(np.abs(u_host).sum())])
    out["u6_segment_sum"] = np.asarray(fml.launch_counts()["segment_sum"])
    return out


def u6_reference(torch):
    """The unsharded run of U6 on the card: the dense trainer's step for a
    data world of ``PR_WORLD`` (each rank's draws over its block of
    pairs, the same negatives on every rank, one sum over the global
    batch), tables replicated."""
    from flinkml_tpu_torch.models import word2vec as w2v
    from flinkml_tpu_torch.ops import threefry

    dev = U_DEVICE
    centers, contexts, pool, v0, u0 = u6_data()
    n_local, local_bs = U_PAIRS // PR_WORLD, U_BATCH // PR_WORLD
    draws = w2v.PairDraws(threefry.PRNGKey(0, dev), local_bs, U_NEG, n_local,
                          U_POOL)
    c_all = torch.from_numpy(centers).to(dev)
    x_all = torch.from_numpy(contexts).to(dev)
    pool_d = torch.from_numpy(pool).to(dev)
    v = torch.from_numpy(v0).to(dev)
    u = torch.from_numpy(u0).to(dev)
    offsets = torch.arange(PR_WORLD, device=dev)[:, None] * n_local
    for step in range(U6_STEPS):
        idx, slots = draws(step)
        rows = (idx[None, :] + offsets).reshape(-1)
        neg = pool_d[slots].repeat(PR_WORLD, 1)
        c, ctx = c_all[rows], x_all[rows]
        gvc, guc, gun = w2v._sgns_pair_grads(
            v[c.long()], u[ctx.long()], u[neg.long()],
            torch.ones(rows.numel(), device=dev))
        scale = U_CHECK_LR / rows.numel()
        v = v - scale * w2v.scatter_rows(c, gvc, U6_VOCAB)
        u = u - scale * (w2v.scatter_rows(ctx, guc, U6_VOCAB)
                         + w2v.scatter_rows(neg, gun, U6_VOCAB))
    return v.cpu().numpy(), u.cpu().numpy()


def u6_check(torch, outs):
    """U6 in the parent: the ranks' tables the same bits (by digest and
    the gathered tables), each strategy's updates within
    :data:`U_UPDATE_TOL` of the unsharded run's on the card. Returns
    ``(record, segment_sum launches)``."""
    t0 = time.perf_counter()
    ref_v, ref_u = u6_reference(torch)
    _, _, _, v0, u0 = u6_data()
    rec = {"vocab": U6_VOCAB, "dim": U_DIM, "steps": U6_STEPS,
           "world": PR_WORLD, "reference_s": time.perf_counter() - t0}
    for strategy in ("ring", "all_to_all"):
        digests = [o[f"u6_{strategy}_digest"].tobytes() for o in outs]
        if len(set(digests)) != 1:
            fail(f"path U6: the ranks' {strategy} tables differ")
        rec[f"{strategy}_s"] = [float(o[f"u6_{strategy}_s"]) for o in outs]
        rec[f"{strategy}_update_err_vs_unsharded"] = {
            name: u_close_updates(f"U6 {strategy} {name} vs the unsharded "
                                  "run", outs[0][f"u6_{strategy}_{name}"],
                                  ref, start)
            for name, ref, start in (("v", ref_v, v0), ("u", ref_u, u0))}
    launches = int(sum(int(o["u6_segment_sum"]) for o in outs))
    if not launches:
        fail("path U6: the all_to_all scatter never launched segment_sum")
    return rec, launches


def recsys_u_path(torch, timer):
    """Path U (module docstring, U1-U5; U6 runs in :func:`pr_ranks`).
    Returns ``(launches by kernel, kernel records)``."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    rec = {"path": "recsys_U", "part_s": {}}
    fml.reset_launch_counts()

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(torch, rec, *args)
        rec["part_s"][name] = time.perf_counter() - t
        return out

    v, docs = part("U1", u1_word2vec)
    ib, vb, w64 = part("U2", u2_fm)
    part("U3", u3_mlp)
    part("U4", u4_text)
    part("U5", u5_streams, docs)
    counts = fml.launch_counts()
    launches = {k: counts[k] for k in ("segment_sum", "spmv", "topk")}
    if not all(launches.values()):
        fail(f"path U: a kernel of the path never launched: {launches}")
    rec["launches"] = launches
    rec["card"] = card_line()
    rec["seconds"] = time.perf_counter() - t0
    log("path " + json.dumps(rec))
    t0 = time.perf_counter()
    data = u_w2v_data()
    neg_ids = data[2][np.random.default_rng(2).integers(
        0, U_POOL, size=U_BATCH * U_NEG)]
    zipf_pool, zipf_vocab = u_zipf_pool(docs)
    zipf_ids = zipf_pool[np.random.default_rng(3).integers(
        0, zipf_pool.size, size=U_BATCH * U_NEG)]
    kernels = {
        "segment_sum": [
            u_segsum_case(torch, timer, "centers, uniform", data[0][:U_BATCH],
                          U_DIM, U_VOCAB),
            u_segsum_case(torch, timer, "negatives, uniform", neg_ids, U_DIM,
                          U_VOCAB),
            u_segsum_case(torch, timer, "negatives, Zipf unigram^0.75",
                          zipf_ids, U_DIM, zipf_vocab)],
        "spmv": u_spmv_case(torch, timer, ib, vb, w64),
        "topk": u_topk_case(torch, timer, v)}
    for name, k in kernels.items():
        log(f"kernel {name} recsys_U " + json.dumps(k))
    log(f"path U kernel cases: {time.perf_counter() - t0:.1f} s")
    return launches, kernels


# -- path V: the device half of the model catalog --------------------------------

#: The forests' near-tie rule: two forests may part only at a node where
#: their best gains lie within this relative gap of each other (the two
#: splits tie within float32 rounding, which then decides); every split
#: before it is equal, and the leaves of trees before it agree within
#: ``V_LEAF_RTOL`` (atol that share of the tree's largest leaf). A boosted
#: forest is compared up to its first parting (later trees fit other
#: residuals); a bagged one tree by tree.
V_TIE_GAP = 1e-4
V_LEAF_RTOL = 1e-5
#: The card's leaves against another run's (the CPU port's, the resumed
#: run's): a leaf is a float32 sum of up to 16,384 rows' g and h each (at
#: V1's shape), added by atomics on the card and in row order on the
#: CPU. The hessians of tree 0 are one value repeated, whose rounding
#: errors do not cancel: two orders part by ≈ 1e-5 of the largest leaf
#: (9.3e-6 of 0.61 on an H100 at V1's shape).
V_CARD_LEAF_RTOL = 1e-4


def forest_arrays(model):
    """``(feats, thresholds, gains, leaves)`` of a fitted forest model of
    either package."""
    return tuple(np.asarray(a) for a in (model._feats, model._thrs,
                                         model._gains, model._leaves))


def forest_parting(ref, got, boosting, gap=V_TIE_GAP, leaf_rtol=V_LEAF_RTOL):
    """Hold forest ``got`` against ``ref`` (:func:`forest_arrays`) by the
    near-tie rule. Returns ``(report, problems)``: the report counts the
    trees compared equal and lists each parting ``[tree, node, relative
    gap]``; ``problems`` lists every breach (empty: the rule holds)."""
    rf, rt, rg, rl = ref
    gf, gt, gg, gl = got
    problems, ties = [], []
    if rf.shape != gf.shape or rl.shape != gl.shape:
        return ({"trees": int(rf.shape[0]), "equal_trees": 0, "ties": []},
                [f"forest shapes differ: {rf.shape}/{rl.shape} vs "
                 f"{gf.shape}/{gl.shape}"])
    equal = 0
    for t in range(rf.shape[0]):
        parted = np.nonzero((rf[t] != gf[t]) | (rt[t] != gt[t]))[0]
        if parted.size == 0:
            scale = float(np.abs(rl[t]).max())
            if not np.allclose(gl[t], rl[t], rtol=leaf_rtol,
                               atol=leaf_rtol * scale):
                problems.append(
                    f"tree {t}: leaves differ by "
                    f"{float(np.abs(gl[t] - rl[t]).max())} (rtol "
                    f"{leaf_rtol}, largest leaf {scale})")
            equal += 1
            continue
        i = int(parted[0])
        rel = abs(float(rg[t, i]) - float(gg[t, i])) / max(
            abs(float(rg[t, i])), 1e-30)
        if not rel <= gap:
            problems.append(
                f"tree {t} node {i}: split (feature {rf[t, i]}, threshold "
                f"{rt[t, i]}) vs (feature {gf[t, i]}, threshold "
                f"{gt[t, i]}) with best gains {rg[t, i]} and {gg[t, i]}: "
                f"relative gap {rel} > {gap}, not a near tie")
        ties.append([t, i, rel])
        if boosting:
            break
    return {"trees": int(rf.shape[0]), "equal_trees": equal,
            "ties": ties}, problems


V_DEVICE = "cuda"
#: V1: ``bench.py:456 _inner_gbt``'s shape: 262,144 x 16 uniform(-1, 1)
#: rows (seed 0), y = x0·x1 > 0, 32 bins, depth 4, 20 trees, lr 0.2.
V_ROWS, V_D, V_BINS, V_DEPTH, V_TREES, V_LR = 262_144, 16, 32, 4, 20, 0.2
#: The card's forest against the CPU port's: training accuracy (on the
#: first V_ACC_ROWS rows) within this.
V_ACC_TOL, V_ACC_ROWS = 0.005, 65_536
#: The CPU port's forests (V1, V3) are fitted with their first trees only,
#: beside the build: a tree's key is ``split(key, T)[t]``, the same for
#: any T, so they are the card's forests' first trees (a boosted tree
#: also sees only the trees before it).
V_CPU_TREES = 5
#: V2: V1's rows in 4 batches, 5 trees, subsample 0.8 (the resume
#: fast-forwards its draws), a crash after the snapshot of tree 3.
V2_BATCHES, V2_TREES, V2_SUBSAMPLE, V2_CRASH = 4, 5, 0.8, 3
#: V3: a random forest on V1's rows, 4 of 16 features a tree, Poisson(1)
#: bootstrap weights.
V3_TREES, V3_FRACTION = 10, 0.25
#: V4: GaussianMixture, k = 8 on 100,000 x 32 float32 blobs, a fixed
#: number of EM iterations (tol 0) against float64 numpy EM.
V4_ROWS, V4_D, V4_K, V4_ITERS, V4_LL_RTOL = 100_000, 32, 8, 10, 1e-5
#: V5: PCA and Correlation at a9a's width (``make_data``, U2's rows);
#: Spearman ranks a 100,000-row prefix on the host.
V5_ROWS, V5_D, V5_SEED, V5_K, V5_SPEARMAN_ROWS = (1_000_000, 123, 5, 10,
                                                   100_000)
#: V6: PowerIterationClustering on a seeded graph (a ring through every
#: vertex, the rest uniform random edges, affinities uniform [0.5, 1.5)).
V6_VERTICES, V6_EDGES, V6_ITERS = 100_000, 1_000_000, 20
#: V7: the selectors', KBinsDiscretizer's and AFT's fits (AFT: 200 Adam
#: steps, batch 4,096).
V7_ROWS, V7_AFT_STEPS = 100_000, 200


def v_sync(torch):
    if V_DEVICE == "cuda":
        torch.cuda.synchronize()


def v_seconds(torch, fn):
    """``(seconds, result)`` of one call, synchronized on the card."""
    v_sync(torch)
    t0 = time.perf_counter()
    out = fn()
    v_sync(torch)
    return time.perf_counter() - t0, out


def v_data():
    """V1's rows (``bench.py:456``'s generator)."""
    if "v_data" not in PREPARED:
        rng = np.random.default_rng(0)
        x = rng.uniform(-1, 1, size=(V_ROWS, V_D)).astype(np.float32)
        PREPARED["v_data"] = (x, (x[:, 0] * x[:, 1] > 0).astype(np.float32))
    return PREPARED["v_data"]


def v_gbt(cls_name="GBTClassifier", layout="segment", trees=None, **kw):
    from flinkml_tpu_torch.models import gbt

    est = getattr(gbt, cls_name)(hist_layout=layout, **kw)
    return (est.set_num_trees(V_TREES if trees is None else trees)
            .set_max_depth(V_DEPTH)
            .set_max_bins(V_BINS).set_learning_rate(V_LR).set_reg_lambda(1.0)
            .set_seed(0))


def v_accuracy(model, x, y) -> float:
    """Training accuracy on the first :data:`V_ACC_ROWS` rows (the host
    walks the forest)."""
    import flinkml_tpu_torch as fml

    x, y = x[:V_ACC_ROWS], y[:V_ACC_ROWS]
    pred = model.transform(fml.Table({"features": x}))[0].column("prediction")
    return float((pred == y).mean())


def v_prefix(model, trees: int, boosting: bool):
    """A copy of a fitted forest model with its first ``trees`` trees (a
    bagged forest averages them)."""
    out = type(model)()
    out.copy_params_from(model)
    out._set_forest(model._feats[:trees], model._thrs[:trees],
                    model._leaves[:trees], model._base, model._depth,
                    model._lr if boosting else 1.0 / trees,
                    model._gains[:trees], model._n_features,
                    model._hash_features)
    return out


def v_forest_check(label, ref, got, boosting, acc_ref=None, acc_got=None):
    """The near-tie rule (:func:`forest_parting`, leaves within
    :data:`V_CARD_LEAF_RTOL`) over ``ref``'s trees, and the training
    accuracies within :data:`V_ACC_TOL`; returns the rule's report."""
    trees = ref._feats.shape[0]
    report, problems = forest_parting(
        forest_arrays(ref), tuple(a[:trees] for a in forest_arrays(got)),
        boosting, leaf_rtol=V_CARD_LEAF_RTOL)
    if problems:
        fail(f"path V: {label}: {problems[0]}")
    if acc_ref is not None and not abs(acc_got - acc_ref) <= V_ACC_TOL:
        fail(f"path V: {label}: accuracy {acc_got} vs {acc_ref} (tolerance "
             f"{V_ACC_TOL})")
    return report


def v_blobs():
    """V4's blobs: 8 centers uniform in [-10, 10)^32, unit normal noise."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(-10, 10, size=(V4_K, V4_D))
    assign = rng.integers(0, V4_K, V4_ROWS)
    return (centers[assign] + rng.normal(size=(V4_ROWS, V4_D))).astype(
        np.float32)


def numpy_gmm_em(x, k, cov_type, iters, seed):
    """Float64 numpy EM from the port's initialization (the host mean
    removed, k-means++ on the centered rows with ``seed``, the data
    variance as every covariance): ``(weights, means, covs)`` in centered
    space after ``iters`` iterations, and the shift."""
    from flinkml_tpu_torch.models import gmm as pgmm
    from flinkml_tpu_torch.models.kmeans import _kmeans_pp_init

    x = np.asarray(x, np.float64)
    shift = x.mean(axis=0)
    xc = x - shift
    rng = np.random.default_rng(seed)
    means = np.asarray(_kmeans_pp_init(xc, k, rng), np.float64)
    var = np.maximum(xc.var(axis=0), pgmm._REG)
    covs = (np.tile(var[None, :], (k, 1)) if cov_type == "diag"
            else np.tile(np.diag(var)[None], (k, 1, 1)))
    weights = np.full(k, 1.0 / k)
    for _ in range(iters):
        logp = numpy_gmm_logp(xc, weights, means, covs, cov_type)
        mx = logp.max(axis=1, keepdims=True)
        resp = np.exp(logp - mx)
        resp /= resp.sum(axis=1, keepdims=True)
        r_k = resp.sum(axis=0)
        r_x = resp.T @ xc
        if cov_type == "diag":
            r_xx = resp.T @ (xc * xc)
        else:
            r_xx = np.stack([(resp[:, j:j + 1] * xc).T @ xc
                             for j in range(k)])
        weights, means, covs = pgmm._m_step(r_k, r_x, r_xx, cov_type)
    return weights, means, covs, shift


def numpy_gmm_logp(x, weights, means, covs, cov_type):
    """``[n, k]`` float64 log(w_j · N(x | mu_j, Sigma_j))."""
    d = x.shape[1]
    out = np.empty((x.shape[0], len(weights)))
    for j in range(len(weights)):
        diff = x - means[j]
        if cov_type == "diag":
            maha = (diff * diff / covs[j]).sum(axis=1)
            logdet = np.log(covs[j]).sum()
        else:
            chol = np.linalg.cholesky(covs[j])
            z = np.linalg.solve(chol, diff.T)
            maha = (z * z).sum(axis=0)
            logdet = 2.0 * np.log(np.diag(chol)).sum()
        out[:, j] = (np.log(weights[j]) - 0.5 * (d * np.log(2 * np.pi)
                                                 + logdet) - 0.5 * maha)
    return out


def numpy_gmm_ll(x, weights, means, covs, cov_type) -> float:
    """Mean float64 log-likelihood of rows ``x`` under a mixture."""
    logp = numpy_gmm_logp(np.asarray(x, np.float64), weights, means, covs,
                          cov_type)
    mx = logp.max(axis=1, keepdims=True)
    return float(np.mean(mx[:, 0] + np.log(np.exp(logp - mx).sum(axis=1))))


def v_graph():
    """V6's edges: a ring through every vertex and uniform random edges."""
    rng = np.random.default_rng(6)
    n, m = V6_VERTICES, V6_EDGES
    ring = np.arange(n)
    src = np.concatenate([ring, rng.integers(0, n, m - n)])
    dst = np.concatenate([(ring + 1) % n, rng.integers(0, n, m - n)])
    return src, dst, rng.uniform(0.5, 1.5, m)


def v_references():
    """Path V's references that need no card, made while the kernels
    build: V1's and V3's forests fitted by the CPU port, V4's float64
    EM, V5's float64 covariance and correlations, V6's float64 power
    iterate."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import pic

    t0 = time.perf_counter()
    refs = {}
    x, y = v_data()
    table = fml.Table({"features": x, "label": y})
    with fml.use_device("cpu"):
        t = time.perf_counter()
        m = v_gbt(trees=V_CPU_TREES).fit(table)
        refs["v1_cpu_s"] = time.perf_counter() - t
        refs["v1"], refs["v1_acc"] = m, v_accuracy(m, x, y)
        rf = v_gbt("RandomForestClassifier", trees=V_CPU_TREES) \
            .set_feature_subset_fraction(V3_FRACTION).fit(table)
        refs["v3"], refs["v3_acc"] = rf, v_accuracy(rf, x, y)
    xb = v_blobs()
    refs["v4_x"] = xb
    for cov in ("diag", "full"):
        w, mu, c, shift = numpy_gmm_em(xb, V4_K, cov, V4_ITERS, 0)
        refs[f"v4_{cov}_ll"] = numpy_gmm_ll(xb - shift, w, mu, c, cov)
    xa = make_data(V5_ROWS, V5_D, seed=V5_SEED)[0].astype(np.float64)
    xa_c = xa - xa.mean(axis=0)
    cov = xa_c.T @ xa_c / (V5_ROWS - 1)
    std = np.sqrt(np.diag(cov))
    refs["v5_cov"], refs["v5_corr"] = cov, cov / np.outer(std, std)
    from scipy.stats import rankdata

    ranks = rankdata(xa[:V5_SPEARMAN_ROWS], axis=0)
    refs["v5_spearman"] = np.corrcoef(ranks, rowvar=False)
    src, dst, w = v_graph()
    ids, s, d, wn, v0, _ = pic.pic_inputs(src, dst, w, 2, 0)
    v = v0.astype(np.float64)
    wn64 = wn.astype(np.float64)
    for _ in range(V6_ITERS):
        v = np.bincount(s, weights=wn64 * v[d], minlength=len(ids))
        v /= np.abs(v).sum()
    refs["v6_inputs"], refs["v6_iterate"] = (s, d, wn, v0), v
    refs["seconds"] = time.perf_counter() - t0
    PREPARED["v_refs"] = refs


def v_segsum_case(torch, timer, x, y):
    """V1's level-0 histogram sum (the first tree's ``[n·d, 2]`` g and h
    into ``n_leaves·d·bins`` = 8,192 segments, of which the level's node
    0 hits 512) and its leaf sums (``[n, 2]`` into 16, by tree 0's
    leaves), each against its plain version, with its bound and
    ``index_add_``'s time."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.models import gbt

    dev = V_DEVICE
    binned = torch.from_numpy(gbt.bin_features(
        x, gbt.quantile_bin_edges(x, V_BINS))).to(dev)
    yd = torch.from_numpy(y).to(dev)
    pos = float(y.sum())
    base = float(np.float32(np.log(pos / (len(y) - pos))))
    g, h = gbt.grad_hess(torch.full_like(yd, base), yd, torch.ones_like(yd),
                         True)
    gh = torch.stack([g, h], dim=1)
    node = torch.zeros(V_ROWS, dtype=torch.int32, device=dev)
    n_leaves = 1 << V_DEPTH
    segments = n_leaves * V_D * V_BINS
    feat = torch.arange(V_D, dtype=torch.int32, device=dev)
    ids = ((node[:, None] * V_D + feat[None, :]) * V_BINS + binned).reshape(-1)
    vals = gh.repeat_interleave(V_D, dim=0)
    # The leaf sums: the same rows' g and h by tree 0's leaf (V1's forest).
    feats, thrs = PREPARED["v1_segment"]._feats, PREPARED["v1_segment"]._thrs
    leaf = np.zeros(V_ROWS, np.int64)
    for level in range(V_DEPTH):
        i = (1 << level) - 1 + leaf
        leaf = leaf * 2 + (x[np.arange(V_ROWS), feats[0, i]] > thrs[0, i])
    records = []
    for label, seg_ids, v, n_seg, tol in (
            ("GBT level-0 histogram, [n·d, 2] g and h", ids, vals, segments,
             1e-5),
            ("GBT leaf sums, [n, 2] g and h", torch.from_numpy(
                leaf.astype(np.int32)).to(dev), gh, n_leaves, 1e-4)):
        got = ksegsum.segment_sum(v, seg_ids, n_seg)
        want = ksegsum.segment_sum_plain(v, seg_ids, n_seg)
        # Tree 0's h is one value, each hit segment sums thousands of it:
        # the rounding errors of a float32 sum in two orders do not cancel
        # as random terms' do (an H100 at level 0: 2.2e-6 of the largest
        # sum).
        scale = float(ksegsum.segment_sum_plain(v.abs(), seg_ids,
                                                n_seg).max())
        check_close(f"path V segment_sum {label}", got, want, 1e-5,
                    tol * scale)
        n_bytes = seg_ids.numel() * 4 + v.numel() * 4 + got.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, v.numel(), "float32")
        long_ids = seg_ids.long()
        records.append({
            "label": label, "shape": [int(seg_ids.numel()), 2, n_seg],
            "segments_hit": int(torch.unique(seg_ids).numel()),
            "max_abs_err": max_err(got, want),
            "ms": timer(lambda: ksegsum.segment_sum(v, seg_ids, n_seg)),
            "plain_ms": timer(lambda: ksegsum.segment_sum_plain(
                v, seg_ids, n_seg)),
            "library_ms": timer(lambda: torch.zeros(
                tuple(got.shape), device=dev).index_add_(0, long_ids, v)),
            "bound_ms": b_ms, "bound_by": b_by})
    return records


def v1_gbt(torch, rec, refs):
    """V1: the boosted forest through ``GBTClassifier.fit`` on the card,
    both layouts; the builder alone (``bench.py``'s row-trees/s); each
    layout built twice to show which is bit for bit."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import gbt
    from flinkml_tpu_torch.parallel import DeviceMesh

    x, y = v_data()
    table = fml.Table({"features": x, "label": y})
    out = {"rows": V_ROWS, "features": V_D, "bins": V_BINS,
           "depth": V_DEPTH, "trees": V_TREES}
    models = {}
    edges = gbt.quantile_bin_edges(x.astype(np.float64), V_BINS)
    binned = gbt.bin_features(x.astype(np.float64), edges)
    pos = float(y.sum())
    base = float(np.float32(np.log(pos / (V_ROWS - pos))))
    mesh = DeviceMesh()
    dev_args = (mesh.shard_batch(binned), mesh.shard_batch(y),
                mesh.shard_batch(np.ones(V_ROWS, np.float32)))
    for layout in ("segment", "cumsum"):
        fit_s, models[layout] = v_seconds(torch, lambda: v_gbt(
            layout=layout).fit(table))
        tables = gbt.sharded_hist_args(binned, mesh, V_BINS, layout)

        def build():
            return gbt.build_forest(
                *dev_args, base=base, lr=float(np.float32(V_LR)), lam=1.0,
                subsample=1.0, seed=0, n_feat=V_D, n_bins=V_BINS,
                depth=V_DEPTH, num_trees=V_TREES, logistic=True,
                hist_layout=layout, hist_tables=tables, mesh=mesh)

        s1, f1 = v_seconds(torch, build)
        s2, f2 = v_seconds(torch, build)
        out[layout] = {
            "fit_s": fit_s, "fit_row_trees_per_s": V_ROWS * V_TREES / fit_s,
            "builder_s": [s1, s2],
            "builder_row_trees_per_s": V_ROWS * V_TREES / min(s1, s2),
            "repeat_bitwise": all(np.array_equal(a, b)
                                  for a, b in zip(f1, f2)),
            "accuracy": v_accuracy(models[layout], x, y)}
    out["segment"]["vs_cpu_port"] = v_forest_check(
        "V1 segment vs the CPU port", refs["v1"], models["segment"], True,
        refs["v1_acc"], v_accuracy(v_prefix(models["segment"], V_CPU_TREES,
                                            True), x, y))
    out["cumsum"]["vs_segment"] = v_forest_check(
        "V1 cumsum vs segment", models["segment"], models["cumsum"], True,
        out["segment"]["accuracy"], out["cumsum"]["accuracy"])
    out["cpu_port_fit_s"] = refs["v1_cpu_s"]
    rec["V1"] = out
    PREPARED["v1_segment"] = models["segment"]


def v2_batches(part=None, parts=1):
    """V1's rows in :data:`V2_BATCHES` batches (``part`` of ``parts``: that
    block of every batch)."""
    x, y = v_data()
    rows = V_ROWS // V2_BATCHES
    out = []
    for b in range(V2_BATCHES):
        xb, yb = x[b * rows:(b + 1) * rows], y[b * rows:(b + 1) * rows]
        if part is not None:
            k = rows // parts
            xb, yb = xb[part * k:(part + 1) * k], yb[part * k:(part + 1) * k]
        out.append({"features": xb, "label": yb})
    return out


def v2_estimator(subsample=V2_SUBSAMPLE, **kw):
    return (v_gbt(trees=V2_TREES, stream_reservoir_capacity=V_ROWS, **kw)
            .set_subsample(subsample))


def v2_stream(torch, rec, tmp):
    """V2: the streamed fit over a sealed cache, uninterrupted, then
    crashed after the snapshot of tree :data:`V2_CRASH` and resumed."""
    from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream

    cache = cache_stream(iter(v2_batches()))
    fit_s, golden = v_seconds(torch, lambda: v2_estimator().fit(cache))

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            path = super().save(state, epoch, extra, **kw)
            if epoch >= V2_CRASH:
                raise RuntimeError("injected crash")
            return path

    ck = os.path.join(tmp, "v2_ck")
    try:
        v2_estimator(checkpoint_manager=Crash(ck), checkpoint_interval=1) \
            .fit(cache)
        fail("path V2: the crash was not injected")
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    resume_s, resumed = v_seconds(torch, lambda: v2_estimator(
        checkpoint_manager=CheckpointManager(ck), checkpoint_interval=1,
        resume=True).fit(cache))
    report = v_forest_check("V2 resume vs the uninterrupted run", golden,
                            resumed, True)
    rec["V2"] = {"batches": V2_BATCHES, "trees": V2_TREES,
                 "crash_after_tree": V2_CRASH, "fit_s": fit_s,
                 "row_trees_per_s": V_ROWS * V2_TREES / fit_s,
                 "resume_s": resume_s, "resume_vs_uninterrupted": report,
                 "resume_bitwise": all(np.array_equal(a, b) for a, b in zip(
                     forest_arrays(golden), forest_arrays(resumed)))}


def v2_rank(torch, rank, out_dir):
    """V2 on one rank of P-R's group: the streamed fit over this rank's
    block of every batch, without subsampling (each rank would draw its
    own mask, as each JAX process does); its forest and ``segment_sum``
    launches."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.parallel import DeviceMesh

    fml.reset_launch_counts()
    t0 = time.perf_counter()
    model = v2_estimator(1.0, mesh=DeviceMesh()).fit(cache_stream(iter(
        v2_batches(rank, PR_WORLD))))
    out = {f"v2_{k}": a for k, a in zip(("feats", "thrs", "gains", "leaves"),
                                        forest_arrays(model))}
    out["v2_s"] = np.asarray(time.perf_counter() - t0)
    out["v2_segment_sum"] = np.asarray(fml.launch_counts()["segment_sum"])
    return out


def v2_rank_check(rec, outs):
    """The two ranks' streamed forest: the same bits on both ranks, and
    by the near-tie rule against the first trees of V1's in-RAM forest on
    the card (the same rows, exact edges, no subsampling). Returns the
    ranks' launches."""
    forests = [tuple(o[f"v2_{k}"] for k in ("feats", "thrs", "gains",
                                             "leaves")) for o in outs]
    for f in forests[1:]:
        if any(a.tobytes() != b.tobytes() for a, b in zip(forests[0], f)):
            fail("path V2: the ranks' streamed forests differ")
    report, problems = forest_parting(
        tuple(a[:V2_TREES] for a in forest_arrays(PREPARED["v1_segment"])),
        forests[0], True, leaf_rtol=V_CARD_LEAF_RTOL)
    if problems:
        fail(f"path V2 ranks vs V1's forest: {problems[0]}")
    launches = int(sum(int(o["v2_segment_sum"]) for o in outs))
    rec["V2_ranks"] = {"world": PR_WORLD, "s": [float(o["v2_s"])
                                                for o in outs],
                       "vs_v1_in_ram": report,
                       "segment_sum_launches": launches}
    return launches


def v3_forest(torch, rec, refs):
    """V3: the random forest on the card against the CPU port's, tree by
    tree; every tree's draws (Poisson weights, feature subset; the first
    tree's float64 uniform mask too) on the card equal to the CPU's; the
    float32 ``log`` of
    every value a uniform draw can take, card against CPU (Knuth's
    Poisson adds them)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import gbt
    from flinkml_tpu_torch.ops import threefry

    x, y = v_data()
    fit_s, rf = v_seconds(torch, lambda: v_gbt(
        "RandomForestClassifier", trees=V3_TREES)
        .set_feature_subset_fraction(V3_FRACTION).fit(
            fml.Table({"features": x, "label": y})))
    report = v_forest_check("V3 random forest vs the CPU port", refs["v3"],
                            rf, False, refs["v3_acc"],
                            v_accuracy(v_prefix(rf, V_CPU_TREES, False), x, y))
    keys = {dev: threefry.split(threefry.PRNGKey(0, dev), V3_TREES)
            for dev in (V_DEVICE, "cpu")}
    subset = max(1, int(round(V3_FRACTION * V_D)))
    unequal = 0
    for t in range(V3_TREES):
        for boosting, lam in ((False, 1.0),) + (((True, 0.8),) if t == 0
                                                else ()):
            mc, fc = gbt.tree_weights(keys[V_DEVICE][t], V_ROWS, lam,
                                      boosting, V_D, subset,
                                      torch.device(V_DEVICE))
            mh, fh = gbt.tree_weights(keys["cpu"][t], V_ROWS, lam, boosting,
                                      V_D, subset, torch.device("cpu"))
            unequal += int((mc.cpu() != mh).sum()) + int((fc.cpu() != fh)
                                                          .sum())
    if unequal:
        fail(f"path V3: {unequal} draws on the card differ from the CPU's")
    bits = torch.arange(1 << 23, dtype=torch.int32) | 0x3F800000
    u = bits.view(torch.float32) - 1.0
    log_card = torch.log(u.to(V_DEVICE)).cpu()
    log_cpu = torch.log(u)
    differ = int((log_card.view(torch.int32) != log_cpu.view(torch.int32))
                 .sum())
    rec["V3"] = {"trees": V3_TREES, "features_a_tree": subset,
                 "fit_s": fit_s, "vs_cpu_port": report,
                 "draws_equal": True,
                 "uniform_values_whose_log_differs": differ}


def v4_gmm(torch, rec, refs):
    """V4: GaussianMixture on the card, diag and full, :data:`V4_ITERS`
    EM iterations; the mean log-likelihood of its mixture against float64
    numpy EM from the same initialization."""
    import flinkml_tpu_torch as fml

    xb = refs["v4_x"]
    out = {"rows": V4_ROWS, "d": V4_D, "k": V4_K, "iterations": V4_ITERS}
    for cov in ("diag", "full"):
        est = (fml.GaussianMixture().set_k(V4_K).set_covariance_type(cov)
               .set_max_iter(V4_ITERS).set_tol(0.0).set_seed(0))
        fit_s, m = v_seconds(torch, lambda: est.fit(
            fml.Table({"features": xb})))
        ll = numpy_gmm_ll(xb, m.weights, m.means, m.covariances, cov)
        want = refs[f"v4_{cov}_ll"]
        if not abs(ll - want) <= V4_LL_RTOL * abs(want):
            fail(f"path V4 {cov}: mean log-likelihood {ll} vs float64 EM "
                 f"{want} (rtol {V4_LL_RTOL})")
        pred = m.transform(fml.Table({"features": xb[:4096]}))[0]
        out[cov] = {"fit_s": fit_s,
                    "rows_x_iterations_per_s": V4_ROWS * V4_ITERS / fit_s,
                    "mean_ll": ll, "numpy_f64_mean_ll": want,
                    "clusters_used": int(len(np.unique(
                        pred.column("prediction"))))}
    rec["V4"] = out


def v5_pca_corr(torch, rec, refs):
    """V5: PCA and Correlation at a9a's width against float64 numpy: the
    explained variances (rtol 1e-4), each component an eigenvector of the
    float64 covariance (residual within 1e-4 of its eigenvalue: the
    spectrum of standard normal rows is nearly degenerate, so components
    are held by what they must satisfy), Pearson within 1e-5, Spearman on
    a 100,000-row prefix within 1e-5."""
    import flinkml_tpu_torch as fml

    xa = make_data(V5_ROWS, V5_D, seed=V5_SEED)[0]
    table = fml.Table({"features": xa})
    fit_s, m = v_seconds(torch, lambda: fml.PCA().set_input_col("features")
                         .set_k(V5_K).fit(table))
    cov = refs["v5_cov"]
    lam_ref = np.sort(np.linalg.eigvalsh(cov))[::-1][:V5_K]
    var_err = float(np.abs(m.explained_variance / lam_ref - 1).max())
    resid = max(float(np.linalg.norm(cov @ c - lam * c) / lam)
                for c, lam in zip(m.components, m.explained_variance))
    if not (var_err <= 1e-4 and resid <= 1e-4):
        fail(f"path V5 PCA: variances off by {var_err}, eigen-residual "
             f"{resid} (1e-4)")
    corr_s, (pear,) = v_seconds(torch, lambda: fml.Correlation().transform(
        table))
    pear_err = float(np.abs(pear.column("corr")[0] - refs["v5_corr"]).max())
    (spear,) = fml.Correlation().set_method("spearman").transform(
        fml.Table({"features": xa[:V5_SPEARMAN_ROWS]}))
    spear_err = float(np.abs(spear.column("corr")[0]
                             - refs["v5_spearman"]).max())
    if not (pear_err <= 1e-5 and spear_err <= 1e-5):
        fail(f"path V5 Correlation: Pearson {pear_err}, Spearman "
             f"{spear_err} (1e-5)")
    rec["V5"] = {"rows": V5_ROWS, "d": V5_D, "k": V5_K, "pca_fit_s": fit_s,
                 "variance_rel_err": var_err, "eigen_residual": resid,
                 "pearson_s": corr_s, "pearson_err": pear_err,
                 "spearman_rows": V5_SPEARMAN_ROWS, "spearman_err": spear_err}


def v6_pic(torch, rec, refs):
    """V6: PowerIterationClustering on the card; its power iterate against
    float64 numpy (1e-4 of the largest entry)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import pic

    src, dst, w = v_graph()
    op = (fml.PowerIterationClustering().set_k(2).set_max_iter(V6_ITERS)
          .set_weight_col("w").set_seed(0))
    tr_s, (out,) = v_seconds(torch, lambda: op.transform(fml.Table(
        {"src": src, "dst": dst, "w": w})))
    s, d, wn, v0 = refs["v6_inputs"]
    up = lambda a: torch.from_numpy(a).to(V_DEVICE)  # noqa: E731
    it_s, v = v_seconds(torch, lambda: pic.power_iteration(
        up(s), up(d), up(wn), up(v0), V6_ITERS))
    want = refs["v6_iterate"]
    err = float(np.abs(v.cpu().numpy() - want).max())
    if not err <= 1e-4 * float(np.abs(want).max()):
        fail(f"path V6: power iterate off by {err}")
    rec["V6"] = {"vertices": V6_VERTICES, "edges": V6_EDGES,
                 "iterations": V6_ITERS, "transform_s": tr_s,
                 "iterations_s": it_s, "iterate_err": err,
                 "cluster_sizes": np.bincount(out.column("prediction")
                                              .astype(np.int64)).tolist()}


def v7_small(torch, rec):
    """V7: one fit and one transform of each selector, KBinsDiscretizer
    and AFTSurvivalRegression on the card; the variance selector and AFT
    against the CPU port (AFT within 1e-4 after 200 steps)."""
    import flinkml_tpu_torch as fml

    rng = np.random.default_rng(7)
    x = rng.normal(size=(V7_ROWS, 8)) * np.linspace(0.01, 2, 8)
    yc = rng.integers(0, 3, V7_ROWS).astype(np.float64)
    cat = np.stack([(yc + rng.integers(0, 2, V7_ROWS)) % 4,
                    rng.integers(0, 5, V7_ROWS)], axis=1).astype(np.float64)
    t = fml.Table({"features": x, "cat": cat, "label": yc})
    out = {}
    t0 = time.perf_counter()
    vt = fml.VarianceThresholdSelector().set_output_col("o") \
        .set_variance_threshold(0.5)
    sel = vt.fit(t).selected_indices
    with fml.use_device("cpu"):
        if not np.array_equal(sel, vt.fit(t).selected_indices):
            fail("path V7: the variance selector differs from the CPU port")
    vt.fit(t).transform(t)
    ufs = (fml.UnivariateFeatureSelector().set_features_col("cat")
           .set_output_col("o").set_selection_threshold(1))
    ufs.fit(t).transform(t)
    for op in (fml.ChiSqTest().set_features_col("cat"), fml.ANOVATest(),
               fml.FValueTest()):
        op.transform(t)
    kb = fml.KBinsDiscretizer().set_input_col("features").set_output_col("o")
    kb.fit(t).transform(t)
    out["selectors_kbins_s"] = time.perf_counter() - t0
    beta = np.asarray([0.5, -0.3, 0.2, 0.0, 0.1, -0.2, 0.3, 0.05])
    tt = np.exp(x @ beta + 0.5 * np.log(rng.exponential(size=V7_ROWS)))
    at = fml.Table({"features": x, "label": tt,
                    "censor": (rng.uniform(size=V7_ROWS) < 0.7).astype(
                        np.float64)})

    def aft():
        return (fml.AFTSurvivalRegression().set_max_iter(V7_AFT_STEPS)
                .set_learning_rate(0.05).set_global_batch_size(4096)
                .set_tol(0.0).set_seed(0).fit(at))

    aft_s, card = v_seconds(torch, aft)
    with fml.use_device("cpu"):
        cpu = aft()
    err = float(np.abs(card.coefficients - cpu.coefficients).max())
    if not (err <= 1e-4 and abs(card.scale - cpu.scale) <= 1e-4):
        fail(f"path V7: AFT on the card off the CPU port by {err}")
    card.transform(at)
    out.update({"aft_fit_s": aft_s, "aft_coef_err_vs_cpu": err})
    rec["V7"] = out


def catalog_v_path(torch, timer):
    """Path V (module docstring, V1-V7; V2's ranks run in
    :func:`pr_ranks`). Returns ``(segment_sum launches, kernel record)``."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    if "v_refs_future" in PREPARED:
        PREPARED.pop("v_refs_future").result()
    elif "v_refs" not in PREPARED:
        v_references()
    refs = PREPARED["v_refs"]
    wait_s = time.perf_counter() - t0
    rec = {"path": "catalog_V", "references_s": refs["seconds"],
           "references_wait_s": wait_s, "part_s": {}}
    fml.reset_launch_counts()

    def part(name, fn, *args):
        t = time.perf_counter()
        fn(torch, rec, *args)
        rec["part_s"][name] = time.perf_counter() - t

    part("V1", v1_gbt, refs)
    with tempfile.TemporaryDirectory() as tmp:
        part("V2", v2_stream, tmp)
    part("V3", v3_forest, refs)
    part("V4", v4_gmm, refs)
    part("V5", v5_pca_corr, refs)
    part("V6", v6_pic, refs)
    part("V7", v7_small)
    launches = fml.launch_counts()["segment_sum"]
    if not launches:
        fail("path V: segment_sum never launched")
    rank_launches = v2_rank_check(rec, PREPARED["pr_outs"])
    rec["segment_sum_launches"] = {"parent": launches,
                                   "V2_ranks": rank_launches}
    rec["card"] = card_line()
    rec["seconds"] = time.perf_counter() - t0
    log("path " + json.dumps(rec))
    x, y = v_data()
    kernels = v_segsum_case(torch, timer, x, y)
    log("kernel segment_sum catalog_V " + json.dumps(kernels))
    return launches + rank_launches, kernels


# -- path W: the host half of the model catalog -------------------------------------

#: W1: LDA at the UCI "Bag of Words" Enron corpus' shape, its counts drawn
#: from a seeded LDA generative process with k = 20 planted topics.
W1_DOCS, W1_VOCAB, W1_TOKENS, W1_K = 39_861, 28_102, 6_400_000, 20
W1_ALPHA, W1_ETA, W1_SEED = 0.1, 0.05, 20   # the planted process
W1_FIT_SEED, W1_PASSES, W1_PREFIX = 0, 10, 2_048
W1_PASS_RTOL = 1e-4        # the prefix pass, card against CPU, of the largest
W1_GAMMA_ULPS = 10         # the card's draws against the CPU's
#: A floor on the mean matched cosine to the planted topics, well above
#: the initial lambda's: a sanity check that the fit learnt the topics.
#: The prefix pass against the CPU port is the check that finds a fault.
W1_COSINE = 0.8
W1_STREAM_BATCHES, W1_STREAM_PASSES = 8, 2
#: W2: OneVsRest over MinMaxScaler -> LogisticRegression at MNIST's width.
W2_ROWS, W2_ITERS, W2_BATCH, W2_LR, W2_ACCURACY = 60_000, 5, 8_192, 1.0, 0.9
W2_RAW_TOL = 1e-5          # float32 P(class) against float64 numpy
#: W3: the tuning tools over LogisticRegression at a9a's shape. The L2
#: term is added to the batch's summed gradient, so a regParam shrinks a
#: step as regParam / 8,192 per row would: 100 and 1000 turn the fitted
#: direction on :func:`w3_data`, and the unregularised fit, in the middle of
#: the grid, wins by ~1e-2 AUC.
W3_ROWS, W3_D, W3_REGS, W3_FOLDS, W3_METRIC_TOL = 32_561, 123, (
    100.0, 0.0, 1000.0), 3, 1e-5
W3_ITERS, W3_BATCH, W3_LR = 10, 8_192, 4.0
#: The CPU port's best metric leads the next by at least this, or the pick
#: is not decided by the data and the check against the card means nothing.
W3_MARGIN = 1e-3
#: W4: Criteo-shaped rows through Imputer, StringIndexer and FeatureHasher
#: into a sparse LogisticRegression.
W4_ROWS, W4_NUMERIC, W4_FEATURES, W4_MAX_INDEX = 65_536, 13, 1 << 18, 10_000
W4_CARDINALITY = (1_460, 583, 100_000, 50_000, 305, 24, 12_517, 633, 3,
                  93_145, 5_683, 100_000, 3_194, 27, 14_992, 100_000, 10,
                  5_652, 2_173, 4, 100_000, 18, 15, 86_000, 105, 42_646)
W4_EPOCHS, W4_LR, W4_TOL, W4_RAW_TOL = 10, 0.1, 1e-4, 1e-5
#: W5: the other new stages on a card-resident Table.
W5_ROWS, W5_D, W5_AGGLOMERATIVE_ROWS, W5_SILHOUETTE_RTOL = 65_536, 8, 2_000, 1e-6


def w_corpus():
    """``(flat, topics)``: the corpus' token cells ``doc·V + word`` (int64,
    sorted, one per token) and the planted ``[k, V]`` topics. Per document:
    a Poisson length of mean tokens/docs, a Dirichlet(0.1) topic mixture,
    and its tokens' words from their topics' Dirichlet(0.05) rows."""
    rng = np.random.default_rng(W1_SEED)
    topics = rng.dirichlet(np.full(W1_VOCAB, W1_ETA), size=W1_K)
    theta = rng.dirichlet(np.full(W1_K, W1_ALPHA), size=W1_DOCS)
    lengths = rng.poisson(W1_TOKENS / W1_DOCS, size=W1_DOCS)
    per_topic = rng.multinomial(lengths, theta)
    cells = []
    for t in range(W1_K):
        docs = np.repeat(np.arange(W1_DOCS, dtype=np.int64), per_topic[:, t])
        cells.append(docs * W1_VOCAB + rng.choice(W1_VOCAB, size=docs.size,
                                                  p=topics[t]))
    flat = np.concatenate(cells)
    flat.sort()
    return flat, topics


def w_dense_counts(flat, lo, hi):
    """Documents ``[lo, hi)`` as dense float32 ``[hi - lo, V]`` counts."""
    a, b = np.searchsorted(flat, [lo * W1_VOCAB, hi * W1_VOCAB])
    out = np.zeros((hi - lo) * W1_VOCAB, np.float32)
    np.add.at(out, flat[a:b] - lo * W1_VOCAB, 1.0)
    return out.reshape(hi - lo, W1_VOCAB)


def w_stream_batches(flat):
    """W1's stream: the corpus in ``W1_STREAM_BATCHES`` batches of rows in
    multiples of 8 (the fit's row tile: only the last batch pads)."""
    step = -(-W1_DOCS // W1_STREAM_BATCHES)
    step += -step % 8
    return [{"x": w_dense_counts(flat, lo, min(lo + step, W1_DOCS))}
            for lo in range(0, W1_DOCS, step)]


def w4_columns():
    """Criteo-shaped rows: 13 integer-valued numeric columns with 20% NaN,
    26 categorical columns of 8-hex-digit strings drawn Zipf-like over
    Criteo's per-column cardinalities (capped at 100,000), and a label
    planted on four categorical columns and one numeric column."""
    rng = np.random.default_rng(41)
    cols, margin = {}, np.zeros(W4_ROWS)
    for j in range(W4_NUMERIC):
        v = np.floor(rng.lognormal(1.0, 1.2, W4_ROWS))
        if j == 0:
            margin += 0.8 * (np.log1p(v) - 1.2)
        v[rng.uniform(size=W4_ROWS) < 0.2] = np.nan
        cols[f"i{j}"] = v
    for j, card in enumerate(W4_CARDINALITY):
        ids = np.minimum(rng.zipf(1.2, W4_ROWS) - 1, card - 1)
        if j < 4:
            margin += rng.normal(size=card)[ids]
        hexes = np.char.mod("%08x", rng.integers(0, 1 << 32, size=card))
        cols[f"c{j}"] = hexes[ids]
    y = (margin + rng.logistic(size=W4_ROWS) > 0).astype(np.float64)
    return cols, y


def w4_features(cols, imputer=None, indexer=None):
    """The W4 host stages: ``Imputer`` (mean) on the numeric columns,
    ``StringIndexer`` (``maxIndexNum`` 10,000, rare values to the catch-all)
    and its ``IndexToStringModel`` on the categorical ones, and
    ``FeatureHasher`` over all 39 into 2^18. Fits the two estimators when
    not given. Returns ``(hashed SparseVector column, imputer, indexer)``."""
    import flinkml_tpu_torch as fml

    num = [f"i{j}" for j in range(W4_NUMERIC)]
    cat = [f"c{j}" for j in range(len(W4_CARDINALITY))]
    t = fml.Table(cols)
    if imputer is None:
        imputer = fml.models.Imputer().set_input_cols(num).set_output_cols(
            [f"{c}_imp" for c in num]).fit(t)
    (t,) = imputer.transform(t)
    if indexer is None:
        indexer = (fml.models.StringIndexer().set_input_cols(cat)
                   .set_output_cols([f"{c}_idx" for c in cat])
                   .set_max_index_num(W4_MAX_INDEX)
                   .set_string_order_type("frequencyDesc")
                   .set_handle_invalid("keep").fit(t))
    (t,) = indexer.transform(t)
    inverse = fml.models.IndexToStringModel.from_indexer(indexer)
    inverse.set_input_cols([f"{c}_idx" for c in cat]).set_output_cols(
        [f"{c}_top" for c in cat])
    (t,) = inverse.transform(t)
    (t,) = (fml.models.FeatureHasher()
            .set_input_cols([f"{c}_imp" for c in num]
                            + [f"{c}_top" for c in cat])
            .set_output_col("features").set_num_features(W4_FEATURES)
            .transform(t))
    return t.column("features"), imputer, indexer


def w3_data():
    """``(x, y)`` at a9a's shape, 32,561 x 123 float32: the columns'
    scales differ, as a9a's binary columns' frequencies do (the first half
    at 1, the rest at 0.3), and the label is a planted direction over all
    of them plus logistic noise. L2 shrinks the low-variance columns'
    coefficients first, so it turns the fitted direction and moves the
    AUC."""
    rng = np.random.default_rng(7)
    scale = np.where(np.arange(W3_D) < W3_D // 2, 1.0, 0.3)
    x = (rng.normal(size=(W3_ROWS, W3_D)) * scale).astype(np.float32)
    margin = x @ (rng.normal(size=W3_D) / scale)
    y = (3.0 * margin / margin.std() + rng.logistic(size=W3_ROWS) > 0)
    return x, y.astype(np.float32)


def w_lr(**kw):
    import flinkml_tpu_torch as fml

    est = fml.LogisticRegression().set_seed(0).set_tol(0.0)
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


def w3_tuners(x, y):
    """W3's CrossValidator and TrainValidationSplit, fitted on the current
    device: ``(cv_model, tvs_model)``."""
    import flinkml_tpu_torch as fml

    models = []
    for cls in (fml.CrossValidator, fml.TrainValidationSplit):
        lr = w_lr(max_iter=W3_ITERS, global_batch_size=W3_BATCH,
                  learning_rate=W3_LR)
        grid = fml.ParamGridBuilder().add_grid(
            lr, fml.LogisticRegression.REG, list(W3_REGS)).build()
        tuner = cls(lr, grid, fml.models.BinaryClassificationEvaluator()
                    .set_metrics_names(["areaUnderROC"])).set_seed(0)
        if cls is fml.CrossValidator:
            tuner.set_num_folds(W3_FOLDS)
        models.append(tuner.fit(fml.Table({"features": x, "label": y})))
    return tuple(models)


def w_references():
    """Path W's inputs and references that need no card, made while the
    kernels build: W1's corpus, its streamed batches and the CPU port's
    first VB pass on the 2,048-document prefix; W3's CPU-port tuners; W4's
    Criteo-shaped columns and the CPU port's hashed features."""
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import lda
    from flinkml_tpu_torch.ops import threefry

    t0 = time.perf_counter()
    refs = {}
    flat, topics = w_corpus()
    refs["w1_corpus"] = (flat, topics)
    refs["w1_batches"] = w_stream_batches(flat)
    prefix = torch.from_numpy(w_dense_counts(flat, 0, W1_PREFIX))
    with fml.use_device("cpu"):
        key = threefry.PRNGKey(W1_FIT_SEED, device="cpu")
        lam0 = lda._initial_lambda(key, W1_K, W1_VOCAB)
        t = time.perf_counter()
        refs["w1_prefix_pass"] = lda.vb_pass(
            prefix, torch.ones(W1_PREFIX),
            torch.from_numpy(lam0.astype(np.float32)), 1.0 / W1_K,
            threefry.fold_in(key, 0)).numpy()
        refs["w1_prefix_cpu_s"] = time.perf_counter() - t
        refs["w1_lam0"] = lam0
        x, y = w3_data()
        t = time.perf_counter()
        refs["w3"] = w3_tuners(x, y)
        refs["w3_cpu_s"] = time.perf_counter() - t
    cols, y4 = w4_columns()
    refs["w4_cols"], refs["w4_y"] = cols, y4
    refs["seconds"] = time.perf_counter() - t0
    PREPARED["w_refs"] = refs


def w1_lda(torch, rec, refs):
    """W1: ``LDA.fit`` (k = 20, 10 passes, tol 0) on the card-resident dense
    counts; the prefix pass against the CPU port's; the fitted topics
    against the planted ones, the bound pass by pass; ``transform``; the
    streamed fit's crash and bit-exact resume."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.models import lda
    from flinkml_tpu_torch.ops import threefry
    from scipy.optimize import linear_sum_assignment

    dev = "cuda"
    flat, topics = refs["w1_corpus"]
    steps = rec.setdefault("W1_step_s", {})
    t_step = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    t = time.perf_counter()
    cells = torch.from_numpy(flat).to(dev)
    counts = torch.zeros(W1_DOCS * W1_VOCAB, dtype=torch.float32, device=dev)
    counts.index_put_((cells,), torch.ones(cells.numel(), dtype=torch.float32,
                                           device=dev), accumulate=True)
    counts = counts.view(W1_DOCS, W1_VOCAB)
    del cells
    tokens = float(counts.sum())
    torch.cuda.synchronize()
    rec["W1_counts"] = {"docs": W1_DOCS, "vocab": W1_VOCAB,
                        "tokens": int(tokens), "bytes": counts.numel() * 4,
                        "upload_s": time.perf_counter() - t}
    if tokens != flat.size:
        fail(f"W1: {tokens} tokens on the card, {flat.size} drawn")

    key = threefry.PRNGKey(W1_FIT_SEED, device=dev)
    lam0 = lda._initial_lambda(key, W1_K, W1_VOCAB)
    # The draws on the card against the CPU's: within gamma's declared
    # ulps (PyTorch's float64 log on each), no flipped decision.
    ulps = np.abs(lam0.view(np.int64) - refs["w1_lam0"].view(np.int64))
    rec["W1_gamma_draws"] = {"differ": int((ulps > 0).sum()),
                             "of": int(ulps.size), "max_ulps": int(ulps.max())}
    if ulps.max() > W1_GAMMA_ULPS:
        fail(f"W1: the card's gamma draws differ from the CPU's: "
             f"{rec['W1_gamma_draws']}")
    lam_dev = torch.from_numpy(lam0.astype(np.float32)).to(dev)
    pass_key = threefry.fold_in(key, 0)
    ones = torch.ones(W1_PREFIX, device=dev)
    got = lda.vb_pass(counts[:W1_PREFIX], ones, lam_dev, 1.0 / W1_K,
                      pass_key).cpu().numpy()
    want = refs["w1_prefix_pass"]
    kv = W1_K * W1_VOCAB
    err = float(np.abs(got[:kv] - want[:kv]).max())
    rel_tail = np.abs(got[kv:] - want[kv:]) / np.abs(want[kv:])
    rec["W1_prefix_pass"] = {"max_abs_err": err,
                             "largest": float(np.abs(want[:kv]).max()),
                             "bound_tokens_rel_err": rel_tail.tolist(),
                             "cpu_s": refs["w1_prefix_cpu_s"]}
    if not (err <= W1_PASS_RTOL * np.abs(want[:kv]).max()
            and rel_tail.max() <= W1_PASS_RTOL):
        fail(f"W1: the prefix pass differs from the CPU port's: "
             f"{rec['W1_prefix_pass']}")
    step("upload, draws and prefix pass")

    # One full pass alone: its device time and the card's busy share.
    w_all = torch.ones(W1_DOCS, device=dev)
    timer = Timer(torch)
    pass_ms = timer(lambda: lda.vb_pass(counts, w_all, lam_dev, 1.0 / W1_K,
                                        pass_key), warmup=1, iters=2)
    share = device_share(torch, lambda: lda.vb_pass(
        counts, w_all, lam_dev, 1.0 / W1_K, pass_key))
    del timer, w_all
    # The bound of a pass: the counts read once an E-step, and the E-steps'
    # two [n, k] x [k, V] products.
    pass_bound, pass_by = bound_ms(
        lda._E_STEPS * counts.numel() * 4,
        lda._E_STEPS * 2 * 2.0 * W1_DOCS * W1_K * W1_VOCAB, "float32")
    step("pass timed and profiled")

    bounds = []
    m_step = lda._m_step

    def recording(*args, **kw):
        out = m_step(*args, **kw)
        bounds.append(out[1])
        return out

    est = fml.models.LDA().set_k(W1_K).set_max_iter(W1_PASSES).set_tol(0.0) \
        .set_seed(W1_FIT_SEED)
    table = fml.Table({"features": counts})
    lda._m_step = recording
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    finally:
        lda._m_step = m_step
    rises = all(b > a for a, b in zip(bounds, bounds[1:]))

    def matched_cosine(tm):
        cos = (tm / np.linalg.norm(tm, axis=1, keepdims=True)) @ (
            topics / np.linalg.norm(topics, axis=1, keepdims=True)).T
        r, c = linear_sum_assignment(-cos)
        return cos[r, c]

    matched = matched_cosine(model.topics_matrix)
    t = time.perf_counter()
    (out,) = model.transform(fml.Table({"features": counts}))
    theta = out.column("topicDistribution")
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t
    rec["W1_fit"] = {
        "passes": W1_PASSES, "fit_s": fit_s, "pass_ms": pass_ms,
        "pass_bound_ms": pass_bound, "pass_bound_by": pass_by,
        "pass_device_busy_share": share,
        "tokens_per_s": tokens * W1_PASSES / fit_s,
        "bound_per_token": bounds, "bound_rises": rises,
        "matched_cosine_mean": float(matched.mean()),
        "matched_cosine_initial": float(matched_cosine(lam0).mean()),
        "matched_cosine_min": float(matched.min()),
        "topics_above_0.9": int((matched > 0.9).sum()),
        "transform_s": transform_s}
    if len(bounds) != W1_PASSES or not np.isfinite(bounds).all() or not rises:
        fail(f"W1: the bound does not rise pass by pass: {bounds}")
    if not matched.mean() >= W1_COSINE:
        fail(f"W1: mean matched cosine {matched.mean()} < {W1_COSINE}")
    if theta.shape != (W1_DOCS, W1_K) or not np.isfinite(theta).all() or \
            not np.allclose(theta.sum(axis=1), 1.0, rtol=1e-6):
        fail("W1: transform's topic mixtures are not distributions")
    del out, table, counts, theta
    step("fit and transform")

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            path = super().save(state, epoch, extra, **kw)
            if epoch >= 1:
                raise RuntimeError("injected crash after pass 1")
            return path

    def stream(**kw):
        return fml.models.LDA(**kw).set_k(W1_K).set_max_iter(W1_STREAM_PASSES) \
            .set_tol(0.0).set_seed(W1_FIT_SEED).set_features_col("x")

    cache = cache_stream(iter(refs["w1_batches"]))
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t = time.perf_counter()
        golden = stream().fit(cache)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t
        try:
            stream(checkpoint_manager=Crash(tmp), checkpoint_interval=1) \
                .fit(cache)
            fail("W1: the injected crash did not fire")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        t = time.perf_counter()
        resumed = stream(checkpoint_manager=CheckpointManager(tmp),
                         checkpoint_interval=1, resume=True).fit(cache)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
    step("stream, crash and resume")
    same = resumed._lambda.tobytes() == golden._lambda.tobytes()
    rec["W1_stream"] = {"batches": cache.num_batches,
                        "passes": W1_STREAM_PASSES, "fit_s": stream_s,
                        "resume_s": resume_s, "resume_bit_for_bit": same}
    if not same:
        fail("W1: the streamed fit's resume differs from the uninterrupted "
             "run")


def multiclass_metrics_numpy(y, pred):
    """Float64 numpy accuracy and the support-weighted precision, recall
    and F1 over the label classes."""
    classes = np.unique(y)
    tp = np.asarray([np.sum((pred == c) & (y == c)) for c in classes], float)
    support = np.asarray([np.sum(y == c) for c in classes], float)
    predicted = np.asarray([np.sum(pred == c) for c in classes], float)
    prec = np.where(predicted > 0, tp / np.maximum(predicted, 1), 0.0)
    recall = tp / support
    f1 = np.where(prec + recall > 0, 2 * prec * recall
                  / np.maximum(prec + recall, 1e-300), 0.0)
    w = support / support.sum()
    return {"accuracy": float(np.mean(pred == y)),
            "weightedPrecision": float(w @ prec),
            "weightedRecall": float(w @ recall), "weightedF1": float(w @ f1)}


def w2_one_vs_rest(torch, rec, refs):
    """W2: ``OneVsRest`` over ``Pipeline(MinMaxScaler, LogisticRegression)``
    on 60,000 x 784 MNIST-like rows in 10 classes; its transform runs each
    class's fitted pipeline through ``fused_chain``. Each class's
    ``rawPrediction``, fused and per stage, against a float64 numpy sigmoid
    of its scaled rows; ``MulticlassClassificationEvaluator`` against
    float64 numpy of the same predictions."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    x, y = mnist_like(W2_ROWS, seed=51)
    inner = fml.Pipeline([
        fml.MinMaxScaler().set_input_col("features").set_output_col("mm"),
        w_lr(features_col="mm", max_iter=W2_ITERS,
             global_batch_size=W2_BATCH, learning_rate=W2_LR)])
    table = fml.Table({"features": torch.from_numpy(x).to("cuda"),
                       "label": y})
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = fml.models.OneVsRest(inner).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    before = fml.launch_counts()["fused_chain"]
    t = time.perf_counter()
    (out,) = model.transform(table)
    pred = out.column("prediction")
    transform_s = time.perf_counter() - t
    launches = fml.launch_counts()["fused_chain"] - before
    pipeline_fusion.set_enabled(False)
    try:
        (per_stage,) = model.transform(table)
    finally:
        pipeline_fusion.set_enabled(True)
    # Each class's P(class) in float64 numpy: its scaler's map folded into
    # its coefficient (a constant 0.5 where a column's span is 0), so that
    # one product scores every class.
    fold = np.empty((x.shape[1], len(model.classes)))
    shift = np.empty(len(model.classes))
    for j, m in enumerate(model.models):
        scaler, lr = m.stages
        d = scaler._arrays()
        span = d["dataMax"] - d["dataMin"]
        fold[:, j] = np.where(span > 0, lr.coefficient
                              / np.where(span > 0, span, 1.0), 0.0)
        shift[j] = 0.5 * lr.coefficient[span <= 0].sum() - d["dataMin"] \
            @ fold[:, j]
    want_raw = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ fold + shift)))
    raw_err = {}
    for name, got in (("fused", out), ("per_stage", per_stage)):
        raw = np.asarray(got.column("rawPrediction"), np.float64)
        raw_err[name] = float(np.abs(raw - want_raw).max()) \
            if raw.shape == want_raw.shape else float("inf")
    names = ["accuracy", "weightedPrecision", "weightedRecall", "weightedF1"]
    (metrics,) = fml.models.MulticlassClassificationEvaluator() \
        .set_metrics_names(names).transform(out)
    want = multiclass_metrics_numpy(y, pred)
    errs = {n: abs(float(metrics.column(n)[0]) - want[n]) for n in names}
    rec["W2"] = {"rows": W2_ROWS, "classes": len(model.classes),
                 "fit_s": fit_s, "transform_s": transform_s,
                 "transform_fused_chain_launches": launches,
                 "raw_prediction_max_abs_err": raw_err,
                 "metrics": want, "metric_max_abs_err": max(errs.values())}
    if not max(raw_err.values()) <= W2_RAW_TOL:
        fail(f"W2: rawPrediction differs from float64 numpy: {raw_err}")
    if launches < len(model.classes):
        fail(f"W2: fused_chain launched {launches} times for "
             f"{len(model.classes)} classes")
    if max(errs.values()) > 1e-12:
        fail(f"W2: the evaluator differs from float64 numpy: {errs}")
    if not want["accuracy"] >= W2_ACCURACY:
        fail(f"W2: accuracy {want['accuracy']} < {W2_ACCURACY}")


def w3_tuning(torch, rec, refs):
    """W3: ``CrossValidator`` (3 folds) and ``TrainValidationSplit`` over
    LogisticRegression's regParam {100, 0, 1000} on :func:`w3_data` on the
    card, against the CPU port's: the metrics within 1e-5 and the same
    pick, which the CPU port's metrics decide by at least ``W3_MARGIN``."""
    x, y = w3_data()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = w3_tuners(x, y)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    out = {"card_s": card_s, "cpu_s": refs["w3_cpu_s"]}
    for name, g, w in zip(("cross_validator", "train_validation_split"),
                          got, refs["w3"]):
        err = float(np.abs(np.subtract(g.avg_metrics, w.avg_metrics)).max())
        ranked = np.sort(w.avg_metrics)
        out[name] = {"best_index": g.best_index, "avg_metrics": g.avg_metrics,
                     "cpu_best_index": w.best_index,
                     "cpu_avg_metrics": w.avg_metrics,
                     "cpu_lead": float(ranked[-1] - ranked[-2]),
                     "max_abs_err": err}
        if not out[name]["cpu_lead"] >= W3_MARGIN:
            fail(f"W3 {name}: the CPU port's metrics {w.avg_metrics} do not "
                 f"decide the pick by {W3_MARGIN}")
        if g.best_index != w.best_index or not err <= W3_METRIC_TOL:
            fail(f"W3 {name}: card {g.best_index} {g.avg_metrics}, CPU port "
                 f"{w.best_index} {w.avg_metrics}")
    rec["W3"] = out


def w4_hashed_lr(torch, rec, refs):
    """W4: the Criteo-shaped rows, their numeric columns card-resident,
    through the host stages into 2^18 hashed features, then
    ``LogisticRegression`` (full batch, 10 epochs) on the sparse path
    (``spmv`` and ``segment_sum``) against float64 numpy within 1e-4 of
    the largest coefficient, and its transform (``spmv``) against a float64
    numpy sigmoid of the CSR rows' margins."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    cols, y = dict(refs["w4_cols"]), refs["w4_y"]
    for j in range(W4_NUMERIC):
        cols[f"i{j}"] = torch.from_numpy(cols[f"i{j}"]).to("cuda")
    t = time.perf_counter()
    feats, _, _ = w4_features(cols)
    host_s = time.perf_counter() - t
    table = fml.Table({"features": feats, "label": y})
    before = fml.launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = w_lr(max_iter=W4_EPOCHS, global_batch_size=W4_ROWS,
                 learning_rate=W4_LR).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    mid = fml.launch_counts()
    (out,) = model.transform(table)
    after = fml.launch_counts()
    indptr, idx, val, _, cy, cw = labeled_sparse_data(table, "features",
                                                      "label")
    ref = numpy_sparse_fit(indptr, idx, val, W4_FEATURES, cy, cw, W4_EPOCHS,
                           W4_LR)
    err = float(np.abs(model.coefficient - ref).max())
    rows = np.repeat(np.arange(W4_ROWS), np.diff(indptr))
    margin = np.bincount(rows, weights=val.astype(np.float64)
                         * model.coefficient[idx], minlength=W4_ROWS)
    raw = np.asarray(out.column("rawPrediction"), np.float64)
    raw_err = float(np.abs(raw[:, 1] - 1.0 / (1.0 + np.exp(-margin))).max()) \
        if raw.shape == (W4_ROWS, 2) else float("inf")
    (auc,) = fml.models.BinaryClassificationEvaluator() \
        .set_metrics_names(["areaUnderROC"]).transform(out)
    fit_launches = {k: mid[k] - before[k] for k in ("spmv", "segment_sum")}
    rec["W4"] = {"rows": W4_ROWS, "features": W4_FEATURES,
                 "nnz": int(indptr[-1]), "host_stages_s": host_s,
                 "fit_s": fit_s, "fit_launches": fit_launches,
                 "transform_spmv_launches": after["spmv"] - mid["spmv"],
                 "max_abs_err": err, "largest": float(np.abs(ref).max()),
                 "transform_raw_max_abs_err": raw_err,
                 "train_auc": float(auc.column("areaUnderROC")[0])}
    if min(fit_launches.values()) < W4_EPOCHS or after["spmv"] == mid["spmv"]:
        fail(f"W4: kernel launches {rec['W4']}")
    if not err <= W4_TOL * np.abs(ref).max():
        fail(f"W4: coefficient differs from float64 numpy by {err}")
    if not raw_err <= W4_RAW_TOL:
        fail(f"W4: the transform's P(1) differs from a float64 numpy "
             f"sigmoid of indptr/idx/val @ coef by {raw_err}")


def w5_cases(rng):
    """``(name, stage builder, columns)`` for W5: every new stage not run by
    W1-W4, on ``W5_ROWS`` rows (AgglomerativeClustering on 2,000); float
    columns go to the card, token and string columns stay on the host."""
    import flinkml_tpu_torch as fml

    m = fml.models
    x = rng.normal(size=(W5_ROWS, W5_D))
    a = rng.normal(size=W5_ROWS)
    a[rng.uniform(size=W5_ROWS) < 0.05] = np.nan
    v = rng.integers(0, 5, size=(W5_ROWS, W5_D)).astype(np.float64)
    v[:, -1] = rng.normal(size=W5_ROWS)   # continuous: passes through
    label = (x[:, 0] + rng.normal(size=W5_ROWS) > 0).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-x[:, 0]))
    words = np.asarray(["the", "a", "cat", "is", "on", "mat", "I", "dog"])
    tokens = np.empty(W5_ROWS, dtype=object)
    for i, ids in enumerate(rng.integers(0, len(words), size=(W5_ROWS, 5))):
        tokens[i] = list(words[ids[:1 + i % 5]])
    small = np.empty(4_000, dtype=object)
    for i in range(small.size):
        small[i] = [f"i{j}" for j in sorted(set(rng.integers(0, 12, 4)))]
    xa = np.concatenate([rng.normal(size=(W5_AGGLOMERATIVE_ROWS // 4, 4)) + c
                         for c in (0, 5, 10, 15)])
    split = [[-np.inf, -1.0, 0.0, 1.0, np.inf]]
    return [
        ("Normalizer", lambda: m.Normalizer().set_input_col("x")
         .set_output_col("o").set_p(3.0), {"x": x}),
        ("ElementwiseProduct", lambda: m.ElementwiseProduct()
         .set_input_col("x").set_output_col("o")
         .set_scaling_vec(list(np.arange(W5_D) - 3.0)), {"x": x}),
        ("VectorSlicer", lambda: m.VectorSlicer().set_input_col("x")
         .set_output_col("o").set_indices([5, 0, 3]), {"x": x}),
        ("PolynomialExpansion", lambda: m.PolynomialExpansion()
         .set_input_col("x").set_output_col("o").set_degree(2), {"x": x}),
        ("Binarizer", lambda: m.Binarizer().set_input_cols(["a", "x"])
         .set_output_cols(["oa", "ox"]).set_thresholds([0.0, 0.5]),
         {"a": np.nan_to_num(a), "x": x}),
        ("Bucketizer", lambda: m.Bucketizer().set_input_cols(["a"])
         .set_output_cols(["o"]).set_splits_array(split)
         .set_handle_invalid("keep"), {"a": a}),
        ("Interaction", lambda: m.Interaction().set_input_cols(["a", "x"])
         .set_output_col("o"), {"a": np.nan_to_num(a), "x": x}),
        ("DCT", lambda: m.DCT().set_input_col("x").set_output_col("o"),
         {"x": x}),
        ("StopWordsRemover", lambda: m.StopWordsRemover()
         .set_input_cols(["t"]).set_output_cols(["o"]),
         {"t": tokens, "x": x}),
        ("RandomSplitter", lambda: m.RandomSplitter()
         .set_weights([0.6, 0.3, 0.1]).set_seed(3), {"x": x, "a": a}),
        ("VectorIndexer", lambda: m.VectorIndexer().set_input_col("v")
         .set_output_col("o").set_max_categories(6), {"v": v}),
        ("SQLTransformer", lambda: m.SQLTransformer().set_statement(
            "SELECT *, ABS(a) * 2 + b AS s FROM __THIS__ WHERE b > -1"),
         {"a": a, "b": x[:, 1].copy(), "x": x}),
        ("FPGrowth", lambda: m.FPGrowth().set_min_support(0.05)
         .set_min_confidence(0.3), {"items": small}),
        ("PrefixSpan", lambda: m.PrefixSpan().set_min_support(0.05)
         .set_max_pattern_length(3).set_sequence_col("items"),
         {"items": small}),
        ("Swing", lambda: m.Swing().set_k(10), {
            "user": rng.integers(0, 3_000, W5_ROWS // 4),
            "item": rng.integers(0, 800, W5_ROWS // 4)}),
        ("AgglomerativeClustering", lambda: m.AgglomerativeClustering()
         .set_num_clusters(4), {"features": xa}),
        ("BinaryClassificationEvaluator", lambda: m
         .BinaryClassificationEvaluator().set_metrics_names(
             ["areaUnderROC", "areaUnderPR", "ks", "logLoss"]),
         {"label": label, "rawPrediction": np.stack([1 - p, p], axis=1)}),
        ("RegressionEvaluator", lambda: m.RegressionEvaluator()
         .set_metrics_names(["rmse", "mae", "r2", "explainedVariance"]),
         {"label": x[:, 0].copy(), "prediction": x[:, 0] + 0.1 * x[:, 1]}),
    ]


def w5_stages(torch, rec, refs):
    """W5: each stage of :func:`w5_cases` on a Table whose numeric columns
    are card tensors, bit for bit against the same stage on the host
    Table; ``ClusteringEvaluator`` (its distances one float32 product on
    the card) within 1e-6."""
    import flinkml_tpu_torch as fml

    rng = np.random.default_rng(61)
    out = {}

    def on_card(cols):
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
                    if v.dtype.kind in "fi" else v) for k, v in cols.items()}

    def run(build, cols):
        stage = build()
        table = fml.Table(cols)
        if hasattr(stage, "fit"):
            stage = stage.fit(table)
        return stage.transform(table)

    for name, build, cols in w5_cases(rng):
        t = time.perf_counter()
        got = run(build, on_card(cols))
        card_s = time.perf_counter() - t
        want = run(build, cols)
        for g, w in zip(got, want):
            for c in w.column_names:
                gc, wc = np.asarray(g.column(c)), np.asarray(w.column(c))
                same = (gc.shape == wc.shape and (
                    [repr(e) for e in gc.reshape(-1)]
                    == [repr(e) for e in wc.reshape(-1)]
                    if wc.dtype == object else
                    gc.astype(wc.dtype).tobytes() == wc.tobytes()))
                if not same:
                    fail(f"W5 {name}: column {c!r} differs card against "
                         "host")
        out[name] = card_s
    xb = np.concatenate([rng.normal(size=(W5_ROWS // 4, W5_D)) + 4 * i
                         for i in range(4)])
    pred = np.repeat(np.arange(4.0), W5_ROWS // 4)
    ev = fml.models.ClusteringEvaluator()
    got = float(ev.transform(fml.Table(on_card(
        {"features": xb, "prediction": pred})))[0].column("silhouette")[0])
    with fml.use_device("cpu"):
        want = float(ev.transform(fml.Table(
            {"features": xb, "prediction": pred}))[0].column("silhouette")[0])
    out["ClusteringEvaluator_rel_err"] = abs(got - want) / abs(want)
    if not out["ClusteringEvaluator_rel_err"] <= W5_SILHOUETTE_RTOL:
        fail(f"W5: silhouette {got} on the card, {want} on the CPU")
    rec["W5_stage_s"] = out


def catalog_w_path(torch):
    """Path W (module docstring, W1-W5). Returns the launches of
    ``fused_chain``, ``spmv`` and ``segment_sum``."""
    import flinkml_tpu_torch as fml

    t0 = time.perf_counter()
    if "w_refs_future" in PREPARED:
        PREPARED.pop("w_refs_future").result()
    elif "w_refs" not in PREPARED:
        w_references()
    refs = PREPARED.pop("w_refs")
    wait_s = time.perf_counter() - t0
    rec = {"path": "catalog_W", "references_s": refs["seconds"],
           "references_wait_s": wait_s, "part_s": {}}
    torch.cuda.empty_cache()
    fml.reset_launch_counts()

    def part(name, fn):
        t = time.perf_counter()
        fn(torch, rec, refs)
        rec["part_s"][name] = time.perf_counter() - t

    part("W1", w1_lda)
    part("W2", w2_one_vs_rest)
    part("W3", w3_tuning)
    part("W4", w4_hashed_lr)
    part("W5", w5_stages)
    counts = fml.launch_counts()
    launches = {k: counts[k] for k in ("fused_chain", "spmv", "segment_sum")}
    for k, n in launches.items():
        if not n:
            fail(f"path W: {k} never launched")
    rec["launches"] = launches
    rec["card"] = card_line()
    rec["seconds"] = time.perf_counter() - t0
    log("path " + json.dumps(rec))
    return launches


# -- path X: the compile-cache store, the tuning table and profiling --------------

#: Path X1's kernel checks in the fresh child (the kernel phase's widths at
#: smaller row counts: the point is a library loaded from the store).
X_SPMV_ROWS = 4_096
X_SEGSUM_CELLS, X_SEGSUM_SEGMENTS = 1 << 18, 100_000
X_TOPK_ROWS, X_TOPK_N, X_TOPK_K = 256, 8_192, 16
#: Rows of one served request in X1 (the replicas' bit-for-bit check) and
#: of X4's traced batch.
X_SERVE_ROWS = 64
#: X4's StepTimer check: a segment_sum long enough (its 512 MB of cells
#: take ≥ 0.17 ms at the card's memory rate) that 20% of it is well above
#: the host's clock and launch noise.
X_TIMER_CELLS, X_TIMER_SEGMENTS, X_TIMER_STEPS = 1 << 26, 1 << 20, 20
#: The tuning table's key for one H100 (path X3).
X_MESH = "cuda/NVIDIA_H100_80GB_HBM3/1"


def x_store_counters() -> dict:
    from flinkml_tpu_torch.utils.metrics import metrics

    return dict(metrics.group("compile_cache").snapshot()["counters"])


def x_kernel_checks(torch) -> dict:
    """``spmv``, ``segment_sum`` and ``topk`` launched once each on this
    process's libraries, held against their plain versions as the kernel
    phase holds them (1e-5; ``topk`` bit for bit). Returns each max abs
    err."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(
        0, SPMV_DIM, size=(X_SPMV_ROWS, SPMV_NNZ)).astype(np.int32)).cuda()
    val = torch.from_numpy(rng.normal(
        size=(X_SPMV_ROWS, SPMV_NNZ)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=SPMV_DIM).astype(np.float32)).cuda()
    got, want = kspmv.spmv(idx, val, w), kspmv.spmv_plain(idx, val, w)
    check_close("path X spmv vs plain", got, want, 1e-5, 1e-5)
    errs = {"spmv": max_err(got, want)}
    ids = torch.from_numpy(rng.integers(
        0, X_SEGSUM_SEGMENTS, size=X_SEGSUM_CELLS).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(
        size=X_SEGSUM_CELLS).astype(np.float32)).cuda()
    got = ksegsum.segment_sum(vals, ids, X_SEGSUM_SEGMENTS)
    want = ksegsum.segment_sum_plain(vals, ids, X_SEGSUM_SEGMENTS)
    check_close("path X segment_sum vs plain", got, want, 1e-5, 1e-5)
    errs["segment_sum"] = max_err(got, want)
    x = torch.from_numpy(rng.normal(
        size=(X_TOPK_ROWS, X_TOPK_N)).astype(np.float32)).cuda()
    (gv, gi), (wv, wi) = ktopk.top_k(x, X_TOPK_K), ktopk.top_k_plain(
        x, X_TOPK_K)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        fail("path X topk differs from top_k_plain")
    errs["topk"] = 0.0
    torch.cuda.synchronize()
    return errs


def x1_child() -> int:
    """Path X1's fresh process (``--x1-child``; the store is
    ``$FLINKML_TPU_COMPILE_CACHE``, filled by the parent's build): load the
    four kernel libraries with no ``nvcc``, load the parent's saved chain
    and serve its first prediction from a ``ReplicaPool`` (the cold start,
    timed from the spawn), scale the pool from 1 to 3 replicas with no new
    build, then launch each kernel against its plain version. Prints one
    JSON report."""
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.pipeline import PipelineModel
    from flinkml_tpu_torch.serving import ReplicaPool, ServingConfig
    from flinkml_tpu_torch.table import Table
    from flinkml_tpu_torch.utils.metrics import metrics

    spawned = float(os.environ["FML_X_SPAWNED"])
    fml.reset_launch_counts()
    outcomes = _build.load_all()
    loaded = x_store_counters()
    rep = {"outcomes": outcomes, "nvcc_after_load": _build.nvcc_runs(),
           "hits": loaded.get("hits", 0), "misses": loaded.get("misses", 0),
           "load_ms": metrics.group("compile_cache").history("load_ms")}
    model = PipelineModel.load(os.environ["FML_X_MODEL"])
    x = np.load(os.environ["FML_X_MODEL"] + ".npy")
    rows = {"features": x[:X_SERVE_ROWS], "label": np.zeros(X_SERVE_ROWS)}
    pool = ReplicaPool(
        model, Table({"features": x[:4], "label": np.zeros(4)}),
        config=ServingConfig(max_batch_rows=256, max_wait_ms=1.0),
        n_replicas=1, output_cols=("prediction", "rawPrediction"),
        name="x1-pool",
    ).start()
    try:
        first = pool.predict(rows)
        rep["first_prediction_s"] = time.time() - spawned
        nvcc_before = _build.nvcc_runs()
        pool.add_replica()
        pool.add_replica()
        outs = [r.engine.predict(rows).columns for r in pool.replicas]
        rep["new_builds_on_scale_up"] = _build.nvcc_runs() - nvcc_before
    finally:
        pool.stop(drain=False)
    rep["replicas"] = len(outs)
    rep["scaled_bitwise"] = all(
        o[c].tobytes() == outs[0][c].tobytes() for o in outs for c in o)
    rep["max_abs_err"] = x_kernel_checks(torch)
    with fml.use_device("cpu"):
        (plain,) = model.transform(Table(dict(rows)))
    want = torch.from_numpy(np.asarray(plain.column("rawPrediction")))
    got = torch.from_numpy(np.asarray(first.columns["rawPrediction"]))
    check_close("path X1 fused_chain vs plain", got, want, 1e-12, 1e-12)
    rep["max_abs_err"]["fused_chain"] = max_err(got, want)
    rep["launches"] = dict(fml.launch_counts())
    rep["nvcc_runs"] = _build.nvcc_runs()
    print(json.dumps(rep), flush=True)
    return 0


def x2_child() -> int:
    """Path X2's fresh process (``--x2-child``): ``spmv``'s entry in the
    store was truncated by the parent; loading it must rebuild it with one
    ``nvcc`` run, count one corrupt entry, and the rebuilt kernel must hold
    against the plain version. Prints one JSON report."""
    import torch

    from flinkml_tpu_torch.kernels import _build

    before = x_store_counters()
    outcome = _build._load("spmv", _build.store())
    after = x_store_counters()
    rep = {"outcome": outcome, "nvcc_runs": _build.nvcc_runs(),
           "corrupt_entries": after.get("corrupt_entries", 0)
           - before.get("corrupt_entries", 0)}
    from flinkml_tpu_torch.kernels import spmv as kspmv

    rng = np.random.default_rng(12)
    idx = torch.from_numpy(rng.integers(
        0, SPMV_DIM, size=(X_SPMV_ROWS, SPMV_NNZ)).astype(np.int32)).cuda()
    val = torch.from_numpy(rng.normal(
        size=(X_SPMV_ROWS, SPMV_NNZ)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=SPMV_DIM).astype(np.float32)).cuda()
    got, want = kspmv.spmv(idx, val, w), kspmv.spmv_plain(idx, val, w)
    check_close("path X2 rebuilt spmv vs plain", got, want, 1e-5, 1e-5)
    rep["max_abs_err"] = max_err(got, want)
    print(json.dumps(rep), flush=True)
    return 0


def x_start_child(mode: str, **env_extra) -> subprocess.Popen:
    """Start ``chip_smoke.py --<mode>`` (on this process's store unless
    ``env_extra`` names another)."""
    env = dict(os.environ, FML_X_SPAWNED=repr(time.time()), **env_extra)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{mode}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def x_child_report(mode: str, proc: subprocess.Popen) -> dict:
    """The child's JSON report (its last line); a failed child fails."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"path X {mode} did not finish in 300 s")
    if proc.returncode != 0:
        fail(f"path X {mode} exited {proc.returncode}:\n{out[-3000:]}\n"
             f"{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def x1_check(rep: dict) -> dict:
    """X1's checks on the fresh child's report."""
    from flinkml_tpu_torch.kernels import _build

    if rep["nvcc_runs"] != 0 or rep["nvcc_after_load"] != 0:
        fail(f"path X1: the child ran nvcc {rep['nvcc_runs']} times")
    if rep["hits"] < len(_build.sources()) or rep["misses"] != 0:
        fail(f"path X1: {rep['hits']} store hits, {rep['misses']} misses "
             f"for {len(_build.sources())} kernel libraries")
    if set(rep["outcomes"].values()) != {"disk"}:
        fail(f"path X1: the libraries loaded as {rep['outcomes']}")
    if rep["replicas"] != 3 or rep["new_builds_on_scale_up"] != 0:
        fail(f"path X1: scale-up to {rep['replicas']} replicas built "
             f"{rep['new_builds_on_scale_up']} libraries")
    if not rep["scaled_bitwise"]:
        fail("path X1: the scaled replicas answer other bits than the first")
    for site in ("spmv", "segment_sum", "topk", "fused_chain"):
        if rep["launches"].get(site, 0) <= 0:
            fail(f"path X1: the child launched no {site}")
    return rep


def x2_torn_store(work: str) -> str:
    """A copy of this process's store whose ``spmv`` library is torn (its
    first half), for X2's fresh child. A copy, never the entry in place:
    this process has the library mapped, and cutting a mapped file under
    it faults the process (SIGBUS)."""
    from flinkml_tpu_torch.kernels import _build

    path = _build.store().entry_path(_build.program_key("spmv"))
    env_dir = os.path.dirname(path)
    copy_dir = os.path.join(work, "store", os.path.basename(env_dir))
    shutil.copytree(env_dir, copy_dir,
                    ignore=shutil.ignore_patterns("*.lock", ".tmp-*"))
    torn = os.path.join(copy_dir, os.path.basename(path))
    with open(torn, "r+b") as fh:
        fh.truncate(os.path.getsize(torn) // 2)
    return os.path.join(work, "store")


def x2_check(rep: dict) -> dict:
    """X2's checks on the child that met the torn ``spmv`` entry."""
    if rep["outcome"] != "compiled" or rep["nvcc_runs"] != 1 \
            or rep["corrupt_entries"] != 1:
        fail(f"path X2: the truncated spmv entry gave {rep}")
    return rep


def x2_env_mismatch() -> dict:
    """X2's second half: this store's ``spmv`` entry copied under another
    environment's namespace is refused (a miss, counted)."""
    from flinkml_tpu_torch import compile_cache
    from flinkml_tpu_torch.kernels import _build

    store = _build.store()
    key = _build.program_key("spmv")
    path = store.entry_path(key)
    bumped = compile_cache.CompileCacheStore(store.directory)
    bumped._env = dict(store._environment(), torch="999.0.0")
    alien = bumped.entry_path(key)
    os.makedirs(os.path.dirname(alien), exist_ok=True)
    for suffix in (".so", ".json"):
        shutil.copy(path[:-3] + suffix, alien[:-3] + suffix)
    before = x_store_counters().get("env_mismatches", 0)
    if bumped._read_disk(key) is not None:
        fail("path X2: an entry of another environment was read")
    rep = {"env_mismatches": x_store_counters().get("env_mismatches", 0)
           - before,
           "namespaces_differ": os.path.dirname(alien)
           != os.path.dirname(path)}
    shutil.rmtree(os.path.dirname(alien), ignore_errors=True)
    if rep["env_mismatches"] != 1 or not rep["namespaces_differ"]:
        fail(f"path X2: {rep}")
    return rep


def x3_table(torch) -> dict:
    """X3: the committed tuning table checks, keys this card, and every
    consumer resolves to its entry; one quick measurement runs."""
    from flinkml_tpu_torch import precision
    from flinkml_tpu_torch.autotune import load_table, mesh_key, search
    from flinkml_tpu_torch.models import _linear_sgd, als, gbt, word2vec
    from flinkml_tpu_torch.serving import autoscaler, engine

    proc = subprocess.run(
        [sys.executable, "-m", "flinkml_tpu_torch.autotune", "--check"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        fail(f"path X3: autotune --check exited {proc.returncode}:\n"
             f"{proc.stderr[-2000:]}")
    rep = {"check": proc.stdout.strip(), "mesh": mesh_key()}
    if rep["mesh"] != X_MESH:
        fail(f"path X3: mesh_key() is {rep['mesh']!r}, not {X_MESH!r}")
    table = load_table()
    cfg = engine.resolve_config(engine.ServingConfig(), torch.device("cuda"))
    resolved = {
        "sparse_layout": _linear_sgd.resolve_layout(),
        "gbt_histogram": gbt.resolve_hist_layout(),
        "als_reduction": als.resolve_layout(),
        "w2v_accum": word2vec.resolve_accum(),
        "serving_max_batch_rows": cfg.max_batch_rows,
        "serving_window_ms": cfg.max_wait_ms,
        "serving_scale_up_backlog": autoscaler._tuned_backlog_threshold(
            autoscaler.SCALE_UP_BACKLOG),
        "int8_min_const_elems": precision.int8_min_const_elems(),
    }
    entries = table.data["entries"].get(X_MESH, {})
    if set(entries) != set(resolved):
        fail(f"path X3: the table's {X_MESH} knobs {sorted(entries)} are "
             f"not the one-card knobs {sorted(resolved)}")
    for knob, value in resolved.items():
        if value != table.value(X_MESH, knob):
            fail(f"path X3: {knob} resolves to {value!r}, the table says "
                 f"{table.value(X_MESH, knob)!r}")
    rep["resolved"] = resolved
    t0 = time.perf_counter()
    rep["quick_gbt_histogram"] = search.measure_gbt_histogram(quick=True)
    rep["quick_s"] = time.perf_counter() - t0
    if not all(v > 0 for v in rep["quick_gbt_histogram"].values()):
        fail(f"path X3: quick measurement {rep['quick_gbt_histogram']}")
    return rep


def x4_profiling(torch, model, x) -> dict:
    """X4: a ``trace`` around one served batch (of ``model``) names the
    ``fused_chain`` kernel; a ``StepTimer`` around ``segment_sum`` reads
    what CUDA events around the same steps read (each step launched on an
    idle card and waited for), within 20% or 20 µs."""
    import glob

    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.serving import ServingConfig, ServingEngine
    from flinkml_tpu_torch.table import Table
    from flinkml_tpu_torch.utils import StepTimer, annotate, trace

    engine = ServingEngine(
        model, Table({"features": x[:4], "label": np.zeros(4)}),
        ServingConfig(max_batch_rows=256, max_wait_ms=1.0),
        output_cols=("prediction",), name="x4").start()
    rows = {"features": x[:X_SERVE_ROWS], "label": np.zeros(X_SERVE_ROWS)}
    log_dir = tempfile.mkdtemp(prefix="fml-x4-trace-")
    try:
        engine.predict(rows)
        with trace(log_dir, ignore_errors=False):
            with annotate("x4_served_batch"):
                engine.predict(rows)
            torch.cuda.synchronize()
        (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        with open(path) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    finally:
        engine.stop(drain=False)
        shutil.rmtree(log_dir, ignore_errors=True)
    kernels = sorted(n for n in names if "fused_chain" in n)
    if not kernels or "x4_served_batch" not in names:
        fail("path X4: the trace of a served batch names no fused_chain "
             "kernel or no annotation")
    gen = torch.Generator(device="cuda").manual_seed(13)
    ids = torch.randint(0, X_TIMER_SEGMENTS, (X_TIMER_CELLS,), device="cuda",
                        dtype=torch.int32, generator=gen)
    vals = torch.randn(X_TIMER_CELLS, device="cuda", generator=gen)
    ksegsum.segment_sum(vals, ids, X_TIMER_SEGMENTS)
    torch.cuda.synchronize()
    timer = StepTimer()
    for _ in range(X_TIMER_STEPS):
        with timer:
            timer.observe(ksegsum.segment_sum(vals, ids, X_TIMER_SEGMENTS))
    event_ms = []
    for _ in range(X_TIMER_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ksegsum.segment_sum(vals, ids, X_TIMER_SEGMENTS)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    event_ms = float(np.mean(event_ms))
    timer_ms = timer.mean * 1e3
    rep = {"trace_kernels": kernels, "step_timer_ms": timer_ms,
           "cuda_event_ms": event_ms}
    if abs(timer_ms - event_ms) > max(0.2 * event_ms, 0.020):
        fail(f"path X4: StepTimer reads {timer_ms:.4f} ms, CUDA events "
             f"{event_ms:.4f} ms")
    return rep


def compile_cache_path(torch) -> dict:
    """Path X: the store (X1 a cold start in a fresh process, X2 a torn
    library rebuilt in another and an entry of another environment
    refused), the tuning table (X3) and profiling (X4). X1's and X2's
    children run while this process checks X2's namespaces and X3; X4
    runs alone after them, for its times. Returns the launch counts of
    this process's work (X3's quick measurement, X4)."""
    import flinkml_tpu_torch as fml

    from flinkml_tpu_torch.autotune.search import _serving_model

    t0 = time.perf_counter()
    rec = {"path": "compile_cache_X"}
    model, x = _serving_model()  # the search's scaler → LR chain, 2,048 x 16
    work = tempfile.mkdtemp(prefix="fml-x-")
    try:
        path = os.path.join(work, "model")
        model.save(path)
        np.save(path + ".npy", x[:X_SERVE_ROWS])
        x1 = x_start_child("x1-child", FML_X_MODEL=path)
        x2 = x_start_child("x2-child",
                           FLINKML_TPU_COMPILE_CACHE=x2_torn_store(work))
        rec["x2_env"] = x2_env_mismatch()
        fml.reset_launch_counts()
        rec["x3"] = x3_table(torch)
        rec["x1"] = x1_check(x_child_report("x1-child", x1))
        rec["x2"] = x2_check(x_child_report("x2-child", x2))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["x4"] = x4_profiling(torch, model, x)
    counts = dict(fml.launch_counts())
    for site in ("fused_chain", "segment_sum"):
        if counts.get(site, 0) <= 0:
            fail(f"path X: {site} never launched in the parent")
    rec["launches"] = counts
    rec["card"] = card_line()
    rec["seconds"] = time.perf_counter() - t0
    log("path " + json.dumps(rec))
    return counts


#: Inputs and float64 references that need no card, made while the kernels
#: build (:func:`prepare_references`) and taken by the path that uses them.
# -- path Y: the static-analysis passes on the card ------------------------------

#: Y1: the bench chain's rows (``bench.py:602``'s width, d = 32) and the row
#: counts transformed inside the warmed 4,096-row bucket, then one across
#: its boundary.
Y_CHAIN_ROWS, Y_CHAIN_D = 8_192, 32
Y_BUCKET_ROWS = (2_049, 2_500, 3_000, 3_333, 3_600, 3_900, 4_000, 4_096)
Y_BOUNDARY_ROWS = 4_097
#: Y2: path H2's block (65,536 Criteo-shaped rows, dim 1e6, ELL width 64).
Y_SORTED_ROWS = 65_536
#: Y3: the estimate against ``max_memory_allocated``: the JAX package's
#: calibration band (``tests/test_analysis_memory.py:387-401``).
Y_MEMORY_BAND = (0.5, 2.0)


def y1_guard(torch, rec):
    """Y1: the bench chain (4 scalers + LR, d = 32, float64) warmed at one
    row bucket, then transformed at 8 row counts inside it and once across
    its boundary under a zero-budget ``TransferRetraceGuard``: no finding,
    no ``nvcc`` run, one ``fused_chain`` launch and one upload a transform;
    an unwarmed chain in the same region raises FML402; the fused outputs
    equal the per-stage chain within 1e-12."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.analysis import GuardViolation, TransferRetraceGuard
    from flinkml_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(22)
    x = rng.normal(size=(Y_CHAIN_ROWS, Y_CHAIN_D))
    coef = rng.normal(size=Y_CHAIN_D)
    pm = fml.PipelineModel(chain_models(x, coef))
    table = fml.Table({"features": x})
    pm.transform(table.slice(0, Y_BUCKET_ROWS[-1]))   # warm the bucket
    torch.cuda.synchronize()
    before = fml.launch_counts()["fused_chain"]
    fusion = metrics.group("pipeline.fusion")
    h2d_before = fusion.snapshot()["counters"].get(
        "host_to_device_transfers", 0)
    n_calls = len(Y_BUCKET_ROWS) + 1
    guard = TransferRetraceGuard(allow_compiles=0, allow_new_buckets=True,
                                 allow_host_to_device=n_calls,
                                 allow_device_to_host=0,
                                 raise_on_violation=False,
                                 location="chip_smoke:Y1")
    outs = []
    with guard:
        for rows in Y_BUCKET_ROWS + (Y_BOUNDARY_ROWS,):
            (out,) = pm.transform(table.slice(0, rows))
            outs.append((rows, out))
    torch.cuda.synchronize()
    launches = fml.launch_counts()["fused_chain"] - before
    if guard.findings or guard.nvcc_runs or launches != n_calls:
        fail(f"Y1: guard findings {[f.render() for f in guard.findings]}, "
             f"nvcc runs {guard.nvcc_runs}, fused_chain launches {launches} "
             f"for {n_calls} transforms")
    h2d = fusion.snapshot()["counters"].get(
        "host_to_device_transfers", 0) - h2d_before
    stages = chain_models(x, coef)[1:]
    stages[0].set(stages[0].INPUT_COL, "features")
    cold = fml.PipelineModel(stages)
    try:
        with TransferRetraceGuard(allow_compiles=0, location="chip_smoke:Y1"):
            cold.transform(table.slice(0, 1_000))
        fail("Y1: an unwarmed chain passed a zero-budget guard")
    except GuardViolation as e:
        rules = sorted({f.rule for f in e.findings})
        if "FML402" not in rules:
            fail(f"Y1: the unwarmed chain raised {rules}, not FML402")
    err = 0.0
    pipeline_fusion.set_enabled(False)
    try:
        for rows, out in (outs[0], outs[-1]):
            (ref,) = pm.transform(table.slice(0, rows))
            for c in ("s4", "rawPrediction"):
                got, want = out.column(c), ref.column(c)
                if got.shape != want.shape or not np.allclose(
                        got, want, rtol=1e-12, atol=1e-12):
                    fail(f"Y1: fused {c} at {rows} rows differs from the "
                         f"per-stage chain by {np.abs(got - want).max()}")
                err = max(err, float(np.abs(got - want).max()))
    finally:
        pipeline_fusion.set_enabled(True)
    rec["Y1"] = {"transforms": n_calls, "fused_chain_launches": launches,
                 "host_to_device_transfers": h2d,
                 "nvcc_runs": guard.nvcc_runs, "findings": 0,
                 "unwarmed_chain": "FML402", "max_abs_err_vs_per_stage": err}


def y2_sorted_step(torch, rec):
    """Y2: FML404 on the real sorted-stream step
    (``_linear_sgd._sorted_column_stepper``) at path H2's block: one
    ``flinkml.segment_sum`` node with ``indices_are_sorted=True`` and no
    finding; the step with the flag ``False`` gives exactly one FML404.
    Then one step on the card: its ``spmv`` and ``segment_sum`` launches
    equal the capture's nodes, and its result is within 1e-5 of the same
    step on CPU copies (the plain versions)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis import (
        check_sorted_scatter_fn,
        check_sorted_scatter_jaxpr,
    )
    from flinkml_tpu_torch.analysis._capture import capture, nodes_named
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.ops.sparse import pack_sorted_sparse_column

    n, dim, nnz = Y_SORTED_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=7)
    col = pack_sorted_sparse_column(criteo_rows(indices, values, n, nnz,
                                                dim))
    if not col.indices_are_sorted:
        fail("Y2: the packed column does not record its sort")
    rng = np.random.default_rng(23)
    coef = torch.from_numpy(
        rng.normal(size=dim).astype(np.float32) * 0.01).cuda()
    yb = torch.from_numpy(y).cuda()
    wb = torch.ones(n, dtype=torch.float32, device="cuda")
    hy = sgd._stream_hypers(STREAM_LR, STREAM_REG, 0.0, torch.float32, "cuda")
    args = (coef, col.indices, col.buf, col.perm, col.segment_ids, yb, wb,
            *hy)
    step = sgd._sorted_column_stepper("logistic", dim)
    t0 = time.perf_counter()
    gm = capture(step, *args)
    capture_s = time.perf_counter() - t0
    segs, spmvs = nodes_named(gm, "segment_sum"), nodes_named(gm, "spmv")
    if [bool(s.args[3]) for s in segs] != [True]:
        fail(f"Y2: the capture's segment_sum nodes {[s.args[2:] for s in segs]}")
    findings = check_sorted_scatter_jaxpr(gm, (3, 4))
    real = sgd.segment_sum

    def unsorted(values, ids, num_segments, indices_are_sorted=False):
        return real(values, ids, num_segments, indices_are_sorted=False)

    sgd.segment_sum = unsorted
    try:
        bad = check_sorted_scatter_fn(sgd._sorted_column_stepper(
            "logistic", dim), args, (3, 4))
    finally:
        sgd.segment_sum = real
    if findings or [f.rule for f in bad] != ["FML404"]:
        fail(f"Y2: the real step {[f.rule for f in findings]}, the False "
             f"copy {[f.rule for f in bad]}")
    torch.cuda.synchronize()
    before = fml.launch_counts()
    new_coef, loss_sum, wsum = step(*args)
    torch.cuda.synchronize()
    after = fml.launch_counts()
    launches = {k: after[k] - before[k] for k in ("spmv", "segment_sum")}
    if launches != {"spmv": len(spmvs), "segment_sum": len(segs)}:
        fail(f"Y2: launches {launches}, capture nodes spmv {len(spmvs)} "
             f"segment_sum {len(segs)}")
    with fml.use_device("cpu"):
        want = step(*(a.cpu() for a in args))
    for name, got, ref in (("coef", new_coef, want[0]),
                           ("loss_sum", loss_sum, want[1])):
        scale = float(ref.abs().max())
        check_close(f"Y2: step {name} vs plain", got.cpu(), ref, 1e-5,
                    1e-5 * scale)
    rec["Y2"] = {"rows": n, "dim": dim, "ell_width": int(col.indices.shape[1]),
                 "cells": int(col.indices.numel()),
                 "capture_s": capture_s,
                 "segment_sum_nodes": len(segs), "spmv_nodes": len(spmvs),
                 "launches": launches, "findings": 0,
                 "false_copy": "FML404",
                 "max_abs_err_vs_plain": max_err(new_coef.cpu(), want[0])}
    return launches


def y3_memory(torch, rec):
    """Y3: ``estimate_fn_memory(step).peak_bytes`` against the bytes the
    card held at the step's peak — ``max_memory_allocated()`` after
    ``reset_peak_memory_stats()``, less what was resident before the step
    other than the step's arguments — for the dense step at the dense fit
    path's shape and the bucketed sparse step (``unsorted``) at
    ``SPARSE_FIT_ROWS``, dim 1e6, 39 nnz: each within
    :data:`Y_MEMORY_BAND`; ``check_memory_fn`` at half the measured peak
    gives FML701."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis import check_memory_fn, estimate_fn_memory
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    hy = tuple(torch.tensor(v, dtype=torch.float32, device="cuda")
               for v in (FIT_LR, 0.0, 0.0))
    x, y, w = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
    dense = (sgd.make_dense_step("logistic", FIT_BATCH),
             (torch.zeros(DENSE_FIT_D, device="cuda"), 0,
              *(torch.from_numpy(a).cuda() for a in (x, y, w)), *hy))
    indptr, indices, values, sy, sw = make_criteo_csr(
        SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ, seed=0)
    data_args, local_bss = sgd.prepare_sparse_buckets(
        indptr, indices, values, SPMV_DIM, sy, sw, FIT_BATCH, seed=0,
        layout="unsorted")
    sparse = (sgd.make_sparse_step_bucketed("logistic", local_bss, SPMV_DIM,
                                            "unsorted"),
              (torch.zeros(SPMV_DIM, device="cuda"), 0, data_args, *hy))
    launches = {"spmv": 0, "segment_sum": 0}
    out = {}
    for name, (step, args) in (("dense", dense), ("sparse", sparse)):
        t0 = time.perf_counter()
        est = estimate_fn_memory(step, *args)
        est_s = time.perf_counter() - t0
        tensors = [a for a in args if torch.is_tensor(a)]
        for a in args:
            if isinstance(a, tuple):
                tensors.extend(a)
        arg_bytes = sum(t.numel() * t.element_size() for t in tensors)
        step(*args)                   # the libraries and allocator warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = fml.launch_counts()
        result = step(*args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base + arg_bytes
        after = fml.launch_counts()
        for k in launches:
            launches[k] += after[k] - before[k]
        del result
        ratio = est.peak_bytes / measured
        lo, hi = Y_MEMORY_BAND
        if not lo <= ratio <= hi:
            fail(f"Y3: {name} step estimate {est.peak_bytes} B vs measured "
                 f"{measured} B (ratio {ratio:.3f} outside [{lo}, {hi}])")
        rules = [f.rule for f in check_memory_fn(
            step, *args, hbm_budget_bytes=measured // 2)]
        if "FML701" not in rules:
            fail(f"Y3: {name} step at half its measured peak gave {rules}")
        out[name] = {"estimate_bytes": est.peak_bytes,
                     "measured_bytes": int(measured),
                     "argument_bytes": int(arg_bytes), "ratio": ratio,
                     "estimate_s": est_s, "half_budget": "FML701"}
    out["sparse"]["buckets"] = len(local_bss)
    rec["Y3"] = out
    return launches


def analysis_path(torch) -> dict:
    """Path Y: Y1, Y2 and Y3 with the launch counters set to 0 before and
    read after; prints the ``analysis:`` line. Returns the launch counts."""
    import flinkml_tpu_torch as fml

    rec = {"path": "analysis_Y"}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    fml.reset_launch_counts()
    y1_guard(torch, rec)
    y2_sorted_step(torch, rec)
    y3_memory(torch, rec)
    torch.cuda.synchronize()
    counts = fml.launch_counts()
    for site in ("fused_chain", "spmv", "segment_sum"):
        if counts[site] <= 0:
            fail(f"path Y: {site} was never launched ({counts})")
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = counts
    rec["card"] = card_line()
    log("analysis: " + json.dumps(rec))
    return counts


PREPARED = {}


def prepare_references() -> float:
    """Fill :data:`PREPARED` (the ``topk`` probe's rows, path J's inputs
    and references, path L's references) and draw the a9a-width rows of
    paths F, U2 and V5: host work that would otherwise wait for the card.
    Path V's references are made on a thread of their own
    (:func:`v_references`, started by :func:`main`).
    Returns its seconds."""
    t0 = time.perf_counter()
    # torch.profiler imports this at its first start (device_share).
    import torch._inductor.config  # noqa: F401

    PREPARED["topk_route_hosts"] = topk_route_hosts()
    # Path Y's first capture imports make_fx's machinery (seconds); here
    # it overlaps the build.
    from flinkml_tpu_torch.analysis._capture import capture, spec

    capture(lambda x: x * 2.0, spec((4,), device="cuda"))
    for n, d, seed in ((SVC_ROWS, SVC_D, 3), (U_FM_ROWS, U_FM_D, 5)):
        make_data(n, d, seed=seed)
    PREPARED["mesh"] = mesh_inputs()
    PREPARED["l_refs"] = timed_refs()
    return time.perf_counter() - t0


def device_share(torch, fn):
    """Share of ``fn``'s wall time during which the card ran kernels or
    copies: the device events' self time from ``torch.profiler`` (None when
    the profiler reports no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:   # the profiler, not the path, failed
        log(f"device share not measured: {e}")
        return None
    busy_us = 0.0
    for e in prof.key_averages():
        # Host ops also carry the device time of the kernels they launch;
        # count each device event once, on the device's own rows.
        if e.device_type == DeviceType.CUDA:
            busy_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    return busy_us / wall_us if busy_us > 0 else None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import flinkml_tpu_torch  # noqa: F401  (fails outside a checkout)
    from flinkml_tpu_torch import compile_cache
    from flinkml_tpu_torch.kernels import _build

    # Path X1: the kernels build into a fresh store, which every process
    # this run starts (ranks, workers, path X's children) shares.
    x_store = tempfile.mkdtemp(prefix="fml-compile-cache-")
    atexit.register(shutil.rmtree, x_store, True)
    os.environ[compile_cache.ENV_DIR_VAR] = x_store
    compile_cache.reset()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # The host references need no kernel: make them while nvcc runs.
    # Paths V's and W's CPU-port and float64 references run beside the
    # build and the earlier paths; each path waits for its own.
    v_pool = ThreadPoolExecutor(max_workers=2)
    PREPARED["v_refs_future"] = v_pool.submit(v_references)
    PREPARED["w_refs_future"] = v_pool.submit(w_references)
    v_pool.shutdown(wait=False)
    with ThreadPoolExecutor(max_workers=1) as pool:
        build = pool.submit(_build.build_all)
        prep_s = prepare_references()
        times = build.result()
    log(f"build: {json.dumps(times)} total {time.perf_counter() - t0:.2f} s")
    log(f"host references made during the build: {prep_s:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]: {line.strip()}")

    t_start = time.perf_counter()

    def mark(name: str) -> None:
        # Seconds since the build ended, so each path's share shows.
        log(f"elapsed {name}: {time.perf_counter() - t_start:.1f} s")

    timer = Timer(torch)
    spmv_rec = spmv_phase(torch, timer)
    spmv_phase(torch, timer, rows=SPARSE_FIT_ROWS)
    spmv_widths_phase(torch)
    chain_rec = chain_phase(torch, timer, "float64", 1e-12, 1e-12)
    chain_phase(torch, timer, "float32", 1e-5, 1e-6)
    chain_ops_phase(torch, timer)
    segsum_rec = segsum_phase(torch, timer)
    segsum_descent_phase(torch, timer)
    topk_rec = topk_phase(torch, timer)
    bf16 = bf16_kernel_phase(torch, timer)
    mark("kernel phase")
    x_counts = compile_cache_path(torch)
    chain_paths_x = x_counts["fused_chain"]
    mark("path X")
    y_counts = analysis_path(torch)
    mark("path Y")
    half_counts, f16 = half_path(torch, timer)
    mark("path Z")

    serve_spmv = sparse_path(torch)
    chain_paths = {"dense": dense_path(torch), "census": census_path(torch),
                   "mnist": mnist_path(torch),
                   "kmeans_serving": kmeans_serving_path(torch)}
    chain_paths["precision_D"], chain_rec["tiers"] = precision_path(
        torch, timer)
    mark("serving paths and D")
    dense_fit_path(torch)
    fit_counts = sparse_fit_path(torch)
    mark("fit paths 5-6")
    stream_counts = stream_path(torch, timer)
    mark("path E")
    svc_counts = svc_path(torch)
    mark("paths E-F")
    ftrl_path(torch)
    mark("path G")
    ingest_path(torch)
    mark("path H1")
    sorted_counts = sorted_stream_path(torch, timer)
    mark("path H2")
    elastic_path(torch)
    mark("paths G-H")
    slice_i_counts = slice_i_path(torch, timer)
    chain_paths["slice_I"] = slice_i_counts["fused_chain"]
    mark("path I")
    mesh_counts, k2, l_counts = mesh_path(torch)
    mark("paths J and L")
    plan_counts, segsum_rec["naive_bayes"] = plan_path(torch, timer, k2)
    chain_paths["plan_K"] = plan_counts.get("fused_chain", 0)
    mark("path K")
    faults_counts = faults_path(torch)
    mark("path M")
    chain_paths["serving_N"] = serving_path(torch)["fused_chain"]
    mark("path N")
    chain_paths["cluster_O"], chain_paths["cluster_O_parent"] = \
        cluster_path(torch)
    mark("path O")
    pqrs_segsum, q_topk, q_kernels, (u6_rec, u6_segsum) = slice_pqrs_path(
        torch, timer)
    segsum_rec["als_Q"] = q_kernels["segment_sum"]
    topk_rec["als_Q"] = q_kernels["topk"]
    mark("paths P-S")
    u_counts, u_kernels = recsys_u_path(torch, timer)
    u_counts["segment_sum"] += u6_segsum
    log("path " + json.dumps(dict(
        {"path": "recsys_U6", "segment_sum_launches": u6_segsum}, **u6_rec,
        card=card_line())))
    for rec, name in ((spmv_rec, "spmv"), (segsum_rec, "segment_sum"),
                      (topk_rec, "topk")):
        rec["recsys_U"] = u_kernels[name]
    mark("path U")
    v_segsum, segsum_rec["catalog_V"] = catalog_v_path(torch, timer)
    mark("path V")
    w_counts = catalog_w_path(torch)
    chain_paths["catalog_W"] = w_counts["fused_chain"]
    mark("path W")
    chain_paths["compile_cache_X"] = chain_paths_x
    chain_paths["analysis_Y"] = y_counts["fused_chain"]
    chain_paths["half_Z"] = half_counts["fused_chain"]
    chain_rec["launches_by_path"] = chain_paths
    chain_rec["launches"] = sum(chain_paths.values())
    for rec, name in ((spmv_rec, "spmv"), (segsum_rec, "segment_sum")):
        rec["launches_by_path"] = {
            "sparse_serving": serve_spmv if name == "spmv" else 0,
            "sparse_fit": fit_counts[name], "stream_E": stream_counts[name],
            "svc_F": svc_counts[name],
            "sorted_stream_H": sorted_counts[name],
            "slice_I": slice_i_counts[name], "mesh_J": mesh_counts[name],
            "plan_K": plan_counts.get(name, 0),
            "stream_mp_L": l_counts[name], "faults_M": faults_counts[name],
            "recsys_U": u_counts[name]}
        if name == "segment_sum":
            rec["launches_by_path"].update(pqrs_segsum)
            rec["launches_by_path"]["catalog_V"] = v_segsum
            rec["launches_by_path"]["compile_cache_X"] = x_counts[name]
        rec["launches_by_path"]["catalog_W"] = w_counts[name]
        rec["launches_by_path"]["analysis_Y"] = y_counts[name]
        rec["launches_by_path"]["half_Z"] = half_counts[name]
        rec["launches"] = sum(rec["launches_by_path"].values())
    topk_rec["launches_by_path"] = {"knn": knn_path(torch, timer),
                                    "lsh": lsh_path(torch, timer),
                                    "als_Q": q_topk,
                                    "recsys_U": u_counts["topk"],
                                    "half_Z": half_counts["topk"]}
    topk_rec["launches"] = sum(topk_rec["launches_by_path"].values())
    mark("KNN and LSH")
    del timer
    kmeans_path(torch)
    mark("KMeans")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for rec in (spmv_rec, segsum_rec, topk_rec):
        rec["bf16"] = bf16[rec["name"]]
    for rec in (spmv_rec, chain_rec, segsum_rec, topk_rec):
        rec["f16"] = f16[rec["name"]]
    print(json.dumps({"kernels": [
        dict({k: r[k] for k in keys},
             **{k: r[k] for k in ("bf16", "f16", "tiers", "launches_by_path",
                                  "naive_bayes", "als_Q", "recsys_U",
                                  "catalog_V")
                if k in r})
        for r in (spmv_rec, chain_rec, segsum_rec, topk_rec)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- optional: one checkout's kernels against another's on the same card ----------

AB_TOPK_CASES = TOPK_CASES[:4]
#: The new chain ops at their paths' shapes (timed where the tree has them).
AB_CHAIN_OP_CASES = tuple(CHAIN_OP_CASES[i] for i in (0, 3, 8))


def ab_inner(tree: str) -> int:
    """Time ``spmv`` (the serving and fit shapes), ``topk`` (four cases of
    its phase), ``segment_sum`` (the fit shape, unsorted and sorted, float32
    and float64) and ``fused_chain`` (100,000 x 32, float64 and float32;
    and, in a tree that has them, the multinomial head, the KMeans head
    and the census prologue at their paths' shapes) through the public
    wrappers of the checkout at ``tree``, by
    :class:`Timer`, and for the last two also by the profiler's device time
    of the kernel alone (the ``... device`` keys: the host's enqueue is in
    the first and not in the second); print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    if not os.path.abspath(_build.__file__).startswith(os.path.abspath(tree)):
        fail(f"--ab-inner imported {_build.__file__}, not {tree}'s")
    _build.build_all()
    timer = Timer(torch)
    out = {"tree": tree}
    for rows in (SPMV_ROWS, SPARSE_FIT_ROWS):
        _, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM, SPMV_NNZ,
                                                   seed=1)
        idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
        val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).cuda()
        w = torch.from_numpy(np.random.default_rng(2).normal(
            size=SPMV_DIM).astype(np.float32)).cuda()
        out[f"spmv {rows} x {SPMV_NNZ}"] = timer(lambda: kspmv.spmv(idx, val,
                                                                     w))
    rng = np.random.default_rng(9)
    for rows, n, k, dtype, _ in AB_TOPK_CASES:
        shape = (n,) if rows is None else (rows, n)
        host = (-rng.integers(0, 176_401, size=shape).astype(dtype)
                if rows == 4096 else
                -np.round(rng.random(size=shape), 3).astype(dtype)
                if rows is None else rng.normal(size=shape).astype(dtype))
        x = torch.from_numpy(host).cuda()
        out[f"topk {list(shape)} k={k}"] = timer(lambda: ktopk.top_k(x, k))
        del x
    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    order = np.argsort(indices, kind="stable")
    for dtype in ("float32", "float64"):
        for sorted_ids in (False, True):
            sel = order if sorted_ids else slice(None)
            ids = torch.from_numpy(indices[sel]).cuda()
            vals = torch.from_numpy(values[sel].astype(dtype)).cuda()
            key = (f"segment_sum {'sorted' if sorted_ids else 'unsorted'} "
                   f"{dtype}")
            call = (lambda: ksegsum.segment_sum(
                vals, ids, SPMV_DIM, indices_are_sorted=sorted_ids))
            out[key] = timer(call)
            out[key + " device"] = kernel_device_ms(torch, call, "segsum")
            del ids, vals
    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    kernels = [s.transform_kernel()
               for s in chain_models(x, rng.normal(size=CHAIN_D))]
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["s4", "prediction", "rawPrediction"])
    consts = tuple(k.constants for k in kernels)
    for dtype in ("float64", "float32"):
        xp = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
        call = (lambda: program([xp], consts, CHAIN_ROWS))
        out[f"fused_chain {dtype}"] = timer(call)
        out[f"fused_chain {dtype} device"] = kernel_device_ms(
            torch, call, "fused_chain")
    out.update(ab_host_us(torch, kspmv, ksegsum, ktopk, program, consts))
    for op, rows, d, k, dtype in AB_CHAIN_OP_CASES:
        key = f"fused_chain {op} {rows}x{d} k={k} {dtype}"
        if not hasattr(kchain, "HEADS"):   # a tree without the op
            out[key] = None
            continue
        kernels, ext, vals, eager, _, _ = chain_op_case(torch, op, rows, d,
                                                        k, dtype)
        prog = kchain.ChainProgram(kernels, ext, eager)
        host = [kk.constants for kk in kernels]
        call = (lambda: prog(vals, host, rows))
        out[key] = timer(call)
        out[key + " device"] = kernel_device_ms(torch, call, "fused_chain")
        del vals
    print(json.dumps(out), flush=True)
    return 0


#: Calls of each wrapper timed on the host clock by :func:`ab_host_us`.
AB_HOST_CALLS = 2_000


def ab_host_us(torch, kspmv, ksegsum, ktopk, program, consts) -> dict:
    """The host time of one wrapper call (µs): ``AB_HOST_CALLS`` calls on
    inputs small enough that the card keeps up (the host enqueues ahead,
    so the loop's host-clock time is the wrappers' own: argument checks,
    the capture flag, ``ctypes`` and the launch), after 50 warm-ups; the
    card is synchronized after the loop only."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 4_096, (64, SPMV_NNZ)).astype(
        np.int32)).cuda()
    val = torch.from_numpy(rng.normal(size=(64, SPMV_NNZ)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=4_096).astype(np.float32)).cuda()
    ids = torch.from_numpy(np.sort(rng.integers(0, 1_024, 4_096)).astype(
        np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=4_096).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32)).cuda()
    xc = torch.from_numpy(rng.normal(size=(64, CHAIN_D))).cuda()
    calls = {
        "spmv": lambda: kspmv.spmv(idx, val, w),
        "segment_sum unsorted": lambda: ksegsum.segment_sum(vals, ids, 1_024),
        "segment_sum sorted": lambda: ksegsum.segment_sum(
            vals, ids, 1_024, indices_are_sorted=True),
        "topk": lambda: ktopk.top_k(x, 4),
        "fused_chain": lambda: program([xc], consts, 64),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AB_HOST_CALLS):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[f"host_us {name}"] = host / AB_HOST_CALLS * 1e6
    return out


#: Path E's main fits timed in each process of ``--ab-stream``.
AB_STREAM_FITS = 2


def ab_stream_inner(tree: str) -> int:
    """Path E's main fit (its Criteo profile, 8 x 65,536 rows in a
    DataCache that spills half, ``STREAM_EPOCHS`` epochs, a snapshot every
    ``STREAM_INTERVAL``) through the checkout at ``tree``, timed
    ``AB_STREAM_FITS`` times after a warm fit; print one JSON line."""
    import shutil

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.kernels import _build

    if not os.path.abspath(fml.__file__).startswith(os.path.abspath(tree)):
        fail(f"--ab-stream-inner imported {fml.__file__}, not {tree}'s")
    _build.build_all()
    n, dim = STREAM_BATCHES * STREAM_ROWS, SPMV_DIM
    indptr, indices, values, y, _ = make_criteo_csr(n, dim, SPMV_NNZ, seed=7)
    dicts, _ = csr_batch_dicts(indptr, indices, values, y, STREAM_BATCHES,
                               STREAM_ROWS, dim)
    batch_bytes = sum(a.nbytes for a in dicts[0].values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_stream_")
    try:
        w = DataCacheWriter(os.path.join(tmp, "spill"),
                            batch_bytes * STREAM_BATCHES // 2)
        for b in dicts:
            w.append(b)
        spilled = w.finish()

        def fit(epochs, manager=None):
            return (fml.LogisticRegression(
                checkpoint_manager=manager,
                checkpoint_interval=STREAM_INTERVAL if manager else 0)
                .set_max_iter(epochs).set_tol(0.0)
                .set_learning_rate(STREAM_LR).set_reg(STREAM_REG)
                .fit(spilled))

        fit(1)
        rates = []
        for i in range(AB_STREAM_FITS):
            manager = CheckpointManager(os.path.join(tmp, f"ckpt{i}"),
                                        max_to_keep=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(STREAM_EPOCHS, manager)
            torch.cuda.synchronize()
            rates.append(n * STREAM_EPOCHS / (time.perf_counter() - t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"tree": tree, "samples_per_s": rates}), flush=True)
    return 0


def ab_main(old: str, inner: str = "--ab-inner") -> int:
    """``--ab OLD``: the kernels of the checkout at OLD and of this one,
    each timed in its own process, in the order old, new, new, old;
    ``--ab-stream OLD``: path E's main fit so (:func:`ab_stream_inner`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(card_line(), flush=True)
    for tree in (old, here, here, old):
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               inner, tree], capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
        if done.returncode != 0 or not lines:
            fail(f"{inner} {tree}: exit {done.returncode}\n"
                 f"{done.stderr[-2000:]}")
        print(lines[-1], flush=True)
    return 0


# -- --flag-cost: the capture flag's host time in the kernel wrappers -------------

#: Alternating blocks of :data:`AB_HOST_CALLS` calls a wrapper in
#: :func:`flag_cost_main`.
FLAG_COST_ROUNDS = 10


def _without_capture_flag(fn):
    """``fn`` re-compiled from its own source without its ``if
    _gate.CAPTURE.on:`` statement: the wrapper as it was before the
    capture existed, in the same module's globals."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    body = tree.body[0].body
    tree.body[0].body = [st for st in body if not (
        isinstance(st, ast.If) and "CAPTURE" in ast.unparse(st.test))]
    if len(tree.body[0].body) != len(body) - 1:
        fail(f"--flag-cost: no capture-flag statement in {fn.__name__}")
    scope: dict = {}
    exec(compile(tree, inspect.getsourcefile(fn), "exec"), fn.__globals__,
         scope)
    return scope[fn.__name__]


def flag_cost_main(device: str = "cuda") -> int:
    """``--flag-cost``: the host time of one call of each kernel wrapper
    with its capture-flag check and without it (:func:`_without_capture_
    flag`), in one process, in :data:`FLAG_COST_ROUNDS` alternating blocks
    of :data:`AB_HOST_CALLS` calls on :func:`ab_host_us`'s tiny inputs
    (the card synchronized after each block, outside its time), and the
    flag read alone (``timeit``); one JSON line. ``fused_chain``'s wrapper
    has no flag."""
    import timeit

    import torch
    from flinkml_tpu_torch.kernels import _gate
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke --flag-cost: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 4_096, (64, SPMV_NNZ)).astype(
        np.int32)).to(device)
    val = torch.from_numpy(rng.normal(size=(64, SPMV_NNZ)).astype(
        np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=4_096).astype(np.float32)).to(device)
    ids = torch.from_numpy(np.sort(rng.integers(0, 1_024, 4_096)).astype(
        np.int32)).to(device)
    vals = torch.from_numpy(rng.normal(size=4_096).astype(np.float32)).to(
        device)
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32)).to(
        device)
    cases = {
        "spmv": (kspmv.spmv, lambda f: f(idx, val, w)),
        "segment_sum unsorted": (ksegsum.segment_sum,
                                 lambda f: f(vals, ids, 1_024)),
        "segment_sum sorted": (ksegsum.segment_sum, lambda f: f(
            vals, ids, 1_024, indices_are_sorted=True)),
        "topk": (ktopk.top_k, lambda f: f(x, 4)),
    }
    out = {"card": card_line() if device == "cuda" else device,
           "calls_per_block": AB_HOST_CALLS, "rounds": FLAG_COST_ROUNDS}
    for name, (wrapper, call) in cases.items():
        plain = _without_capture_flag(wrapper)
        us = {"flag": [], "no_flag": []}
        for r in range(FLAG_COST_ROUNDS):
            order = (("flag", wrapper), ("no_flag", plain))
            for key, fn in (order if r % 2 == 0 else order[::-1]):
                for _ in range(50):
                    call(fn)
                sync()
                t0 = time.perf_counter()
                for _ in range(AB_HOST_CALLS):
                    call(fn)
                us[key].append((time.perf_counter() - t0)
                               / AB_HOST_CALLS * 1e6)
                sync()
        diffs = [a - b for a, b in zip(us["flag"], us["no_flag"])]
        out[name] = {"flag_us": float(np.median(us["flag"])),
                     "no_flag_us": float(np.median(us["no_flag"])),
                     "median_diff_us": float(np.median(diffs)),
                     "diff_quartiles_us": [float(q) for q in
                                           np.percentile(diffs, [25, 75])]}
    reads = 1_000_000
    out["flag_read_ns"] = timeit.timeit(lambda: _gate.CAPTURE.on,
                                        number=reads) / reads * 1e9
    out["empty_call_ns"] = timeit.timeit(lambda: None,
                                         number=reads) / reads * 1e9
    print(json.dumps(out), flush=True)
    return 0


# -- --variants: edited kernel sources timed through the wrappers -----------------

_CHAIN_DIV = ("row_round<NARROW>(row_round<NARROW>(v - a) / b)",
              "row_round<NARROW>(row_round<NARROW>(v - a) * b)")
_CHAIN_DIV2 = ("if (op & 4u) v = row_round<NARROW>(v / b);",
               "if (op & 4u) v = row_round<NARROW>(v * b);")
_CHAIN_LOAD = ("if (active && row + step < n_rows) W::load(src.x + (row + step) "
               "* d + col, next);",
               "for (int j = 0; j < V; ++j) next[j] = T(j) + T(0.25);")
_CHAIN_STORE = ("if (a.out != nullptr) store_chunk<NARROW>(a.out, row * d + col, v);",
                "if (a.out != nullptr && v[0] == T(-12345)) "
                "store_chunk<NARROW>(a.out, row * d + col, v);")

#: The sorted repair launched from the device, only by a grid that sees a
#: descent, as a tail launch (it starts after the whole grid): no second
#: launch on ascending ids, and still the sum on any ids. It needs
#: relocatable device code and the device runtime, which slow the rest of
#: the library (PERF.md, section 6).
_SEGSUM_TAIL_LAUNCH = (
    "segsum: the sorted repair as a device tail launch (-rdc)", "segsum.cu",
    [("  const bool repair = __ldcg(work) != 0u;\n"
      "  __syncthreads();   // every thread has read the flag before it is "
      "cleared\n"
      "  if (!repair) return;\n", ""),
     ("  if (threadIdx.x == 0) *work = 0u;\n}\n",
      "  if (threadIdx.x == 0) *work = 0u;\n}\n"
      "template <typename T>\n"
      "__device__ __noinline__ void repair_after_grid(\n"
      "    const T* values, const int32_t* ids, int cells, int k,\n"
      "    int num_segments, T* out, unsigned* work) {\n"
      "  if (atomicExch(work, 1u) != 0u) return;\n"
      "  segsum_sorted_repair<T><<<1, kRepairThreads, 0, "
      "cudaStreamTailLaunch>>>(\n"
      "      values, ids, cells, k, num_segments, out, work);\n"
      "  if (cudaGetLastError() != cudaSuccess) __trap();\n}\n"),
     ("    atomicOr(work, 1u);\n",
      "    repair_after_grid(values, ids, cells, 1, num_segments, out, "
      "work);\n"),
     ("      if (threadIdx.x == 0) atomicOr(work, 1u);\n",
      "      if (threadIdx.x == 0) repair_after_grid(values, ids, cells, k, "
      "num_segments, out, work);\n"),
     ("    segsum_sorted_repair<T><<<1, kRepairThreads, 0, s>>>(\n"
      "        v, i, cells, k, num_segments, o, work);\n", "")],
    ("-rdc=true", "-lcudadevrt"))

#: The head's rounding and output type decided at compile time in the
#: untiered kernels (NARROW = kWide: ``rnd``, ``raw_ty`` and ``pred_ty``
#: fold to 0), the form that a review asked for; as built they are tested
#: at run time in every kernel.
_CHAIN_COMPILE_TIME_HEAD = (
    "chain: the head's rounding at compile time", "chain.cu",
    [("template <typename T, int HEAD>\n"
      "__device__ __forceinline__ void class_head(",
      "template <typename T, int HEAD, int NARROW>\n"
      "__device__ __forceinline__ void class_head("),
     ("  const int rnd = a.rnd;\n  T x2 = T(0);",
      "  const int rnd = NARROW ? a.rnd : 0;\n  T x2 = T(0);"),
     ("head_out(e / s, rnd), a.raw_ty);",
      "head_out(e / s, rnd), NARROW ? a.raw_ty : 0);"),
     ("static_cast<T>(bi), a.pred_ty);",
      "static_cast<T>(bi), NARROW ? a.pred_ty : 0);"),
     ("class_head<T, HEAD>(", "class_head<T, HEAD, NARROW>("),
     ("  [[maybe_unused]] const bool plain_out =\n"
      "      a.rnd == 0 && a.raw_ty == kOutT && a.pred_ty == kOutT;",
      "  [[maybe_unused]] const bool plain_out = !NARROW || (\n"
      "      a.rnd == 0 && a.raw_ty == kOutT && a.pred_ty == kOutT);")])
#: The int8 table's staging loop: removed (the untiered chains never take
#: it), or called out of line so that it does not share the body's
#: registers.
_CHAIN_INT8_LOOP = ("  if (a.qseg != nullptr) {\n"
                    "    for (int s = 0; s < a.n_seg; ++s) {")
_CHAIN_NO_INT8 = ("chain: no int8 staging", "chain.cu",
                  [(_CHAIN_INT8_LOOP, "  if (false) {\n"
                    "    for (int s = 0; s < a.n_seg; ++s) {")])
_CHAIN_INT8_NOINLINE = (
    "chain: int8 staging out of line", "chain.cu",
    [(_CHAIN_INT8_LOOP,
      "  if (a.qseg != nullptr) {\n"
      "    stage_int8<T>(a.qseg, a.n_seg, a.qf, a.qc, smem);\n"
      "  } else if (false) {\n"
      "    for (int s = 0; s < a.n_seg; ++s) {"),
     ("template <typename T, typename Body>\n"
      "__device__ __forceinline__ void with_table(",
      "template <typename T>\n"
      "__device__ __noinline__ void stage_int8(const int* qseg, int n_seg,\n"
      "                                        const double* qf,\n"
      "                                        const signed char* qc, T* smem) {\n"
      "  Args<T> a{};\n"
      "  a.qseg = qseg;\n  a.n_seg = n_seg;\n  a.qf = qf;\n  a.qc = qc;\n"
      "  for (int s = 0; s < n_seg; ++s) {\n"
      "    const int off = qseg[8 * s], len = qseg[8 * s + 1];\n"
      "    for (int r = threadIdx.x; r < len; r += blockDim.x) {\n"
      "      smem[off + r] = seg_value(a, s, r);\n"
      "    }\n  }\n}\n"
      "template <typename T, typename Body>\n"
      "__device__ __forceinline__ void with_table(")])

#: The class heads' code shape: their loops not unrolled, or the head
#: called out of line (its registers apart from the row's).
_CHAIN_HEAD_DOT = "    for (int j = 0; j < d; ++j) dot += xr[j] * wt[j * k + c];"
_CHAIN_HEAD_SHAPES = (
    ("chain: the head's dot not unrolled", "chain.cu",
     [(_CHAIN_HEAD_DOT, "#pragma unroll 1\n" + _CHAIN_HEAD_DOT)]),
    ("chain: the head's dot unrolled 4", "chain.cu",
     [(_CHAIN_HEAD_DOT, "#pragma unroll 4\n" + _CHAIN_HEAD_DOT)]),
    ("chain: the head's dot unrolled 8", "chain.cu",
     [(_CHAIN_HEAD_DOT, "#pragma unroll 8\n" + _CHAIN_HEAD_DOT)]),
    ("chain: the head's class loops not unrolled", "chain.cu",
     [("    for (int c = lane; c < k; c += 32) {\n",
       "#pragma unroll 1\n    for (int c = lane; c < k; c += 32) {\n"),
      ("  for (int c = lane; c < k; c += 32) {\n    T dot = T(0);",
       "#pragma unroll 1\n  for (int c = lane; c < k; c += 32) {\n"
       "    T dot = T(0);")]),
    ("chain: the head out of line", "chain.cu",
     [("__device__ __forceinline__ void class_head(",
       "__device__ __noinline__ void class_head(")]),
)
#: The bf16 element type dropped from the parts' load switch (wrong for
#: bf16 inputs; the timed chains have none).
_CHAIN_NO_BF16_LOAD = [
    ("    case kBF16:\n"
     "      return T(__bfloat162float(static_cast<const __nv_bfloat16*>(src)"
     "[i]));\n", ""),
    ("  if (elem == kF32 || elem == kF64 || elem == kBF16 || elem == kF16) {",
     "  if (elem == kF32 || elem == kF64 || elem == kF16) {")]
_CHAIN_LOAD_SHAPES = (
    ("chain: no bf16 case in the loads", "chain.cu", _CHAIN_NO_BF16_LOAD),
    ("chain: no bf16 case in the loads, the head's rounding at compile "
     "time", "chain.cu", _CHAIN_NO_BF16_LOAD + _CHAIN_COMPILE_TIME_HEAD[2]),
)

#: (name, source, literal edits[, extra nvcc flags]): what each step of a
#: kernel costs. A variant that removes work gives wrong outputs on
#: purpose.
VARIANTS = (
    ("chain as built", "chain.cu", []),
    ("chain: no x loads, no s4 stores", "chain.cu",
     [_CHAIN_LOAD, _CHAIN_STORE]),
    ("chain: the 4 divisions as multiplies", "chain.cu",
     [_CHAIN_DIV, _CHAIN_DIV2]),
    ("chain: no sigmoid in the head", "chain.cu",
     [("const T p = T(1) / (T(1) + exp_t(-acc));", "const T p = acc;")]),
    ("chain: 256-thread blocks", "chain.cu",
     [("constexpr int kVecThreads = 128;", "constexpr int kVecThreads = 256;")]),
    ("segsum as built", "segsum.cu", []),
    ("segsum: sorted runs stop at the owner's cells", "segsum.cu",
     [("    while (going && j < cells) {", "    while (false && j < cells) {")]),
    ("segsum: sorted without the gap zeroes", "segsum.cu",
     [("  zero_gaps(lo, hi, out);\n", "")]),
    ("segsum: sorted without the repair launch", "segsum.cu",
     [("    segsum_sorted_repair<T><<<1, kRepairThreads, 0, s>>>(",
       "    if (false) segsum_sorted_repair<T><<<1, kRepairThreads, 0, s>>>(")]),
    ("segsum: sorted without the descent test", "segsum.cu",
     [("        descent |= id[i] < cur;\n", "")]),
    _SEGSUM_TAIL_LAUNCH,
    ("segsum: bf16 unsorted as 16-bit RED", "segsum.cu",
     [("  const uintptr_t at = reinterpret_cast<uintptr_t>(p);\n",
       "  asm volatile(\"red.global.add.noftz.bf16 [%0], %1;\" ::\"l\"(p), "
       "\"h\"(__bfloat16_as_ushort(v)) : \"memory\");\n  return;\n"
       "  const uintptr_t at = reinterpret_cast<uintptr_t>(p);\n")]),
    _CHAIN_COMPILE_TIME_HEAD,
    _CHAIN_NO_INT8,
    _CHAIN_INT8_NOINLINE,
    *_CHAIN_HEAD_SHAPES,
    *_CHAIN_LOAD_SHAPES,
)


def build_variants(variants):
    """Write and build every variant (one ``nvcc`` each, in parallel, with
    the kernels' flags and the variant's own, into
    ``kernels/build/variants``); ``{name: CDLL}``."""
    import ctypes

    from flinkml_tpu_torch.kernels import _build

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, started = _build.nvcc_path(), []
    for i, (name, source, edits, *more) in enumerate(variants):
        flags = more[0] if more else ()
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                fail(f"variant {name!r}: {old!r} is not in {source}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *flags, "-o",
                                 lib, path],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, proc, lib))
    libs = {}
    for name, proc, lib in started:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"variant {name!r} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


class Through:
    """Route the kernel launches of the wrappers to ``lib`` while open."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        import ctypes

        from flinkml_tpu_torch.kernels import _build

        self.orig = _build.function

        def function(name, symbol, argtypes, restype=ctypes.c_int):
            fn = getattr(self.lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), restype
            return fn
        _build.function = function

    def __exit__(self, *exc):
        from flinkml_tpu_torch.kernels import _build

        _build.function = self.orig


def kernel_device_ms(torch, fn, name: str, iters: int = 20):
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``name``, from ``torch.profiler`` (None when it reports none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key)
    return total / iters / 1e3 if total > 0 else None


def variants_main(only: str = "") -> int:
    """``--variants [A|B...]``: every entry of :data:`VARIANTS` (whose
    name holds one of the ``|``-separated substrings) through the port's own wrapper at the kernel
    phase's shapes (``fused_chain`` 100,000 x 32 and the A/B's chain ops,
    ``segment_sum`` at the fit shape), timed by :class:`Timer` and by the
    profiler's device time of the kernel alone; one JSON line each."""
    import torch

    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    if not torch.cuda.is_available():
        print("chip_smoke --variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    timer = Timer(torch)
    variants = tuple(v for v in VARIANTS
                     if any(o in v[0] for o in only.split("|")))
    libs = build_variants(variants)

    def report(name, call, kernel, **keys):
        with Through(libs[name]):
            rec = {"variant": name, **keys, "ms": timer(call),
                   "device_ms": kernel_device_ms(torch, call, kernel)}
        print(json.dumps(rec), flush=True)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    kernels = [s.transform_kernel()
               for s in chain_models(x, rng.normal(size=CHAIN_D))]
    consts = tuple(k.constants for k in kernels)
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["s4", "prediction", "rawPrediction"])
    for dtype in ("float64", "float32"):
        xp = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
        for name, source, *_ in variants:
            if source == "chain.cu":
                report(name, lambda: program([xp], consts, CHAIN_ROWS),
                       "fused_chain", dtype=dtype)
    for op, rows, d, k, dtype in AB_CHAIN_OP_CASES:
        op_kernels, ext, vals, eager, _, _ = chain_op_case(torch, op, rows,
                                                           d, k, dtype)
        prog = kchain.ChainProgram(op_kernels, ext, eager)
        host = [kk.constants for kk in op_kernels]
        for name, source, *_ in variants:
            # The 256-thread variant keeps the wrapper's shared memory
            # sizes for 128: not for the class heads.
            if source == "chain.cu" and "256-thread" not in name:
                report(name, lambda: prog(vals, host, rows), "fused_chain",
                       dtype=dtype, op=op)
        del vals

    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    order = np.argsort(indices, kind="stable")
    for dtype in ("float32", "float64", "bfloat16"):
        for sorted_ids in (True, False):
            sel = order if sorted_ids else slice(None)
            ids = torch.from_numpy(indices[sel]).cuda()
            vals = torch.from_numpy(values[sel]).to("cuda",
                                                    getattr(torch, dtype))
            for name, source, *_ in variants:
                # The "sorted" variants edit the sorted path only, the
                # "bf16" ones the bf16 path.
                if source != "segsum.cu" or (
                        ": sorted" in name and not sorted_ids) or (
                        "bf16" in name and dtype != "bfloat16"):
                    continue
                report(name, lambda: ksegsum.segment_sum(
                    vals, ids, SPMV_DIM, indices_are_sorted=sorted_ids),
                    "segsum", dtype=dtype, sorted=sorted_ids)
            del ids, vals
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-inner":
        sys.exit(ab_inner(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-stream":
        sys.exit(ab_main(sys.argv[2], "--ab-stream-inner"))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-stream-inner":
        sys.exit(ab_stream_inner(sys.argv[2]))
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--flag-cost":
        sys.exit(flag_cost_main(*sys.argv[2:]))
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--variants":
        sys.exit(variants_main(*sys.argv[2:]))
    if len(sys.argv) == 2 and sys.argv[1] == "--o-scaleout":
        sys.exit(o_scaleout_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--j2-rank":
        sys.exit(j2_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pr-rank":
        sys.exit(pr_rank(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--x1-child":
        sys.exit(x1_child())
    if len(sys.argv) == 2 and sys.argv[1] == "--x2-child":
        sys.exit(x2_child())
    sys.exit(main())
