#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training (float32 and bf16),
generation, NeuralCF, checkpoint, sequence-model, ResNet-50, Cluster
Serving, int8 inference, serving-fleet, training-observability, host
data, object-detection, layer-library, model-interop, estimator
(nnframes, LocalEstimator, the attention backward's other routes,
RayContext, AutoML) and data-, sequence-, tensor-, pipeline- and
expert-parallel paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --phase estimators|parallel|layout [--ranks N]

It runs from the root of a checkout of the repository, on a machine with
a CUDA card, PyTorch built for CUDA and the CUDA toolkit (``nvcc``). It
imports nothing of JAX or of the JAX package. Phases, one JSON line each:

1. device  -- the card, the device count, ``nvidia-smi``'s name and power
              limit, the software versions.
2. build   -- every kernel built from ``ops/csrc`` with nvcc for sm_90a
              (one nvcc per source, all started together): seconds, the
              ``-Xptxas -v`` register, shared memory and spill lines, and
              per kernel symbol the count of tensor-core instructions
              (HGMMA, HMMA) in ``cuobjdump -sass``; every instantiation of
              the three flash kernels must hold some.
3. kernels -- each kernel against its plain PyTorch version on the card,
              one line per case and dtype, each case also called twice
              and held bit for bit equal: the flash-attention forward
              (K1), its backward dq and dkv kernels (K2, K3), the fused
              dropout+add+layer-norm forward and backward (K4, K5),
              among the cases the shapes of the parallel phase's ranks
              (K1-K3 at (32, 512, 6, 64) and, for leg D, (8, 512, 6,
              64); K4/K5 on 8,192 rows and, for leg E's microbatches,
              1,024 rows); then
              ``torch.autograd.grad`` through ``flash_attention_blhd``
              against the plain backward.
4. serve   -- the BERT-base classifier of ``bench.py`` (full width and
              depth, weights from ``--seed``) behind ``InferenceModel``
              answers 8 requests of 8 x 512 tokens from 2 client threads;
              outputs are checked, the forward kernel's launch count is
              read, and one row is checked against the port's CPU run.
5. train   -- the same classifier with dropout 0.1 through
              ``Model.compile`` (adam, sparse categorical cross-entropy)
              and ``Model.fit`` for 8 steps at batch 32 on one seeded
              batch of 32 x 512 tokens (lengths 64-512): every loss finite
              and falling, every parameter's gradient finite after the
              first step and every block's qkv_w gradient nonzero, the
              five kernels' launch counts per step, ``evaluate``; then a
              dropout-off step on 2 rows against the port's CPU run.
              ``train_bf16``: the same in bfloat16 (``set_compute_dtype``)
              on int32 ids: every kernel launch given bf16 tensors, the
              parameters, gradients and Adam moments float32, the
              dropout-off step against the port's CPU bf16 step, and the
              float32 and bf16 steps timed in alternating windows (the
              bf16 step's device time by kernel group beside them).
6. timing  -- request latency, tokens/s and peak memory of the served
              model and the forward kernel at the serving shape (profiler
              device time, CUDA events beside it); the
              training step's time, tokens/s, peak memory and
              ``torch.profiler`` device time by kernel group; and each
              kernel at the training shape beside its plain version, its
              bound and the PyTorch library call where there is one.
7. generate -- a GPT-width ``TransformerLayer`` (GPT-1's 12 blocks, 768
              wide, 12 heads, 512 positions, vocab 40990; weights from
              ``--seed``) generates through ``ContinuousBatchScheduler``
              over ``TransformerDecodeEngine``: 16 greedy requests of 48
              tokens on 8 slots (every request committed once with 48
              tokens; the flash forward launched 12 times a prefill and
              nothing else; one request's prefill logits and first 16
              tokens against the port's CPU run; tokens/s, TTFT, the
              decode step at a full gang, peak memory); then 8 requests
              of 24 tokens through chunked joins, prefix-cache hits, int8
              slabs and speculative decoding with a 2-block draft, each
              stream equal to the plain one (int8: agreement reported);
              ``decode_chunk`` against repeated ``decode_step`` and the
              cached-decode probe on the card; and the timing of prefill
              (B=1 x 512, B=4 x 384; the flash forward there beside its
              bound and SDPA) and of one decode step at a gang of 8 and
              capacity 512 (wall, host enqueue, device busy and idle).
8. ncf     -- ``bench.py``'s NeuralCF (MovieLens-1M's 6040 users and
              3706 items, 5 classes, embeddings of 20, hidden 40-20-10,
              MF branch; weights from ``--seed``) through ``fit`` on
              bench.py's 262,144 synthetic ratings at batch 8192, float32:
              steps/s as bench_ncf reckons it (a warm-up epoch, then 3
              windows of 2 epochs), the loss finite and falling,
              ``evaluate``, one step's launches and device idle share;
              ``predict`` on the card against the CPU, ``predict_classes``,
              ``predict`` on a feature set and ``recommend_for_user``.
9. checkpoint -- the engine's checkpoint store, failure policy,
              accumulation and persistence on the ``train_bf16``
              classifier cut to 4 of its 12 blocks (``CKPT_BLOCKS``,
              full width; bf16, int32 ids, dropout 0.1, Adam) over 8
              distinct batches of 32 x 512 (random labels) for 2 epochs,
              a checkpoint every 4 steps, keeping 2: a reference run with
              TensorBoard summaries (one Loss a 2-step window, each the
              step loss it names) and validation; a run whose step 10
              fails (``ZOO_TPU_FAULT=step:raise@10``) and is retried from
              ``ckpt-8`` in the same ``fit``; a run preempted at step 6
              (the drain writes ``ckpt-6``) and a new model from another
              seed resuming it (``auto_resume``); a run with async
              writes. Each equals the reference bit for bit (parameters,
              Adam moments, step, losses), and the async run's files
              carry the reference's crc32c. A byte flipped in the newest
              ``optim.npz`` falls back to ``ckpt-12``, equal to the
              reference's state there. Accumulation 4 launches K1-K5
              16/16/16/32/32 a step; its step time and peak memory beside
              accumulation 1's; a dropout-off step against accumulation 1
              in float32 and bf16 (at 12 blocks). ``save_model`` then
              ``InferenceModel.load`` serves the trained classifier and a
              ResNet-50 ``ZooModel`` (seeded moving statistics) bit for
              bit against ``predict``. Reported: checkpoint bytes, each
              save's seconds (snapshot, serialisation, crc32c, write), the
              async stall, load seconds, crc32c GB/s, the step with an
              async checkpoint every 4 steps against none in alternating
              windows, free disk. Its directories, under
              ``build/chip_smoke_checkpoint``, are deleted at the end.
10. sequence -- the recurrent layers through the zoo's sequence models,
              float32, TF32 off, weights from ``--seed``. The
              TextClassifier of the reference's news20 example (20
              classes, 500 tokens, a seeded (5001, 200) table through a
              frozen ``WordEmbedding``, encoder 256, batch 128, Adagrad
              0.01) with each encoder (cnn, lstm, gru): ``predict`` on 32
              rows against the port's CPU run; 8 ``fit`` steps on one batch
              (the loss finite and falling, a gradient on every trainable
              parameter, the table unmoved); ``evaluate``; the three steps
              timed in alternating windows (p50, launches a step, device
              busy and idle share, peak memory). Then AnomalyDetector
              (unroll 24, hidden 8-32-15, dropouts 0.2, batch 1024), KNRM
              (10 + 40 tokens, vocab 20,000, 300-d, 21 kernels; ranking
              by the reference's route: 32 queries and 512 documents as
              TextSets through tokenize, normalize, word2idx and
              shape_sequence, ``TimeDistributed(knrm.model)`` fitted with
              ``rank_hinge`` on the 256 pairs of ``from_relation_pairs``,
              NDCG@3 and MAP on ``from_relation_lists``; classification
              on arrays; NDCG@3 and MAP against the CPU),
              SessionRecommender (10,000 items, widths 40-20, with
              history; ``recommend_for_session`` against the CPU) and
              Seq2seq (LSTM, 2 layers of 256, a dense
              bridge, a TimeDistributed generator; ``infer`` against the
              CPU's and against ``infer_reference`` with a stop sign):
              ``predict`` against the CPU and 4 falling ``fit`` steps each.
              The launch counts are set to 0 as the phase starts and read
              as it ends (and after each fit and infer): K1-K5 are
              launched 0 times in the whole phase, timed and profiled
              steps included, and the summary line's
              ``launches_sequence`` is that count.
11. resnet -- ``bench.py``'s ResNet-50 leg: ``ImageClassifier(1000,
              "resnet-50")`` on 3 x 224 x 224 (weights from ``--seed``):
              ``predict`` and one SGD step (float32 and bf16, on 3
              starts with the residual branches' last gammas drawn from
              U(0.1, 0.25)) against the port's CPU run: the loss, the
              moving statistics and every layer's forward and backward
              from the card's own inputs;
              ``fit`` for 8 steps in bf16 at batch 256 on one seeded batch
              (the loss finite and falling, every BatchNorm's float32
              moving statistics moved, float32 weights, gradients and SGD
              state, a gradient on every convolution, the five kernels
              launched 0 times, ``evaluate``, ``predict`` rows summing to
              1); the bf16 and float32 steps in alternating windows (p50,
              images/s, MFU by bench.py's count, peak memory, device time
              by kernel group, the SGD update's share).
12. cluster_serving -- Cluster Serving: the ``resnet`` phase's ResNet-50
              (weights from ``--seed``, saved with ``save_model`` and
              deployed by ``InferenceModel.load``) and the ``generate``
              phase's GPT-width decoder (``build_transformer_engine``)
              behind one ``ClusterServing`` (config as a dict: batch 16,
              buckets 1-16, top 5, 2 decode workers, 8 generate slots,
              ``max_len`` 512, 32 new tokens) on a ``FileStreamQueue``.
              A client process writes 256 predict records of (3, 224,
              224) float32 and 32 generate records (prompts of 32-448
              tokens, every 9th record) as fast as it can and waits for
              all 288 with ``OutputQueue.wait_all``. Gated: every uri
              answered once, no duplicate or gap in the queue's ledger,
              nothing dropped, dead-lettered or shed; ``warmup`` ran all
              5 buckets; the top-5 rows against the port's CPU predict
              (16 images, 1e-4) and the card's direct predict (all, 1e-5;
              two classes within the tolerance may trade places); every
              stream equal to the scheduler's alone on the same engine,
              8 also to ``greedy_reference``; K1 launched 12 times a
              prefill and K2-K5 never, in the main run and over the phase.
              Then a ``ModelRegistry`` with v1 and v2 (seed + 1; a canary
              of weight 0.5) behind ``RoutedClusterServing`` on the
              in-process queue: 64 records, each against its version's
              direct predict, the canary's share against crc32 of the
              uris; v2 promoted, v1 undeployed, the manifest listing v2
              alone. Timed: the pipelined and synchronous loops in
              alternating windows of 128 records (records/s, per-row
              queue, device and server ms p50/p95, buckets), a window's
              device busy and idle share, warm-up a bucket, TTFT,
              end-to-end and tokens/s of the generate records, peak
              memory. Its files, under ``build/chip_smoke_serving``, are
              deleted at the end.
13. int8   -- int8 inference (``QuantizedModel``), float32 with TF32 off,
              weights from ``--seed``: ``bench.py``'s bench_quant MLP
              (512-1024-1024-128, batch 64) and CNN (3 x 64 x 64, batch
              8), calibrated on 3 seeded batches: the JAX package's chain
              plan, and under a ``TorchDispatchMode`` census one int32
              product a kernel (``torch._int_mm``), no float product, a
              rounding a chain edge plus the entry quantize and one
              division; ``ImageClassifier(1000, "vgg-16")`` on 3 x 224 x
              224 calibrated on 4 seeded batches of 8: 15 chain edges, 16
              int32 products, one division, one softmax; 2 images against
              the port's CPU int8 run from the same scales (every int32
              accumulator and int8 activation equal, the softmax within
              1e-6); ``save_calibration`` then ``load_quantized`` (the
              same chains, the rows bit for bit); ResNet-50 (54 kernels,
              no chain) deployed as v1 float32 and v2 int8
              (``deploy(quantize=True)`` of the same directory, canary
              0.5) behind ``RoutedClusterServing``: 64 records each
              against its version's direct predict, distinct dispatch
              keys, ``recover`` reloading v2 as int8, 2 rows against the
              CPU's int8 run (the top class equal, within 2e-2 of the
              row's largest probability: the float batch norm between int8
              convolutions rounds differently on the card); int8 against
              float32 reported. Timed: both models in float32 and int8 at
              batch 16 and 64 in alternating windows (records/s, device
              time by group, launches, idle share, peak memory), the
              parameter bytes and the phase's peak memory. K1-K5 are
              launched 0 times in the phase. Its files, under
              ``build/chip_smoke_int8``, are deleted at the end.
14. fleet  -- the rest of Cluster Serving through the port's CLI
              (``python -m analytics_zoo_tpu_torch.serving.cli``), the
              cluster_serving phase's deployment (bench.py's ResNet-50,
              weights from ``--seed``, saved with ``save_model``; batch
              16, buckets 1-16, top 5, float32, TF32 off in every process:
              ``NVIDIA_TF32_OVERRIDE=0`` in the workers' environment),
              tensor records of (3, 224, 224) float32 from client
              processes. Leg A: ``init`` (a second refuses), ``status`` 3,
              ``start --device cuda`` (a second refuses), 64 records each
              answered once, the top-5 rows within 1e-5 of the card's
              direct predict and 16 within 1e-4 of the CPU's, ``status``
              0, ``restart``, 16 more, ``stop``, ``shutdown``, no pidfile.
              Leg B: ``broker`` and ``fleet --workers 2 --transport
              socket://...`` as processes (min = max = 2 workers); a clean
              window of 64 records; 128 records with worker 1 SIGKILLed
              once 32 are answered (its heartbeat on disk): the broker
              redelivers, every record is enqueued, delivered and acked
              once, the supervisor restarts the worker and ``status``
              shows it; every worker pid among ``nvidia-smi``'s compute
              apps; then the same fleet with the echo stub (0 ms a batch)
              for the socket transport's ceiling (128 records). Leg C: 2
              broker processes, a fleet of 2 over their ``shard://``
              spec, 64 records spread over both, a status row for each
              shard. Reported: records/s of each leg, the ceiling, each
              worker's seconds from spawn to first heartbeat, each leg's
              seconds (``leg_seconds``), the phase's wall.
              K1-K5 are launched 0 times in this process over the phase
              (``launches_fleet``). Its files, under
              ``build/chip_smoke_fleet``, are deleted at the end.
15. observe -- the training side of observability on the ``train_bf16``
              classifier (bench.py's widths, 4 of its 12 blocks, bf16,
              int32 ids, dropout 0.1, Adam; weights from ``--seed``) in
              a context with the
              health monitor, the memory accountant, telemetry into a
              trace dir and the profiler hook over steps 5-6. A: ``fit``
              for 16 steps at 32 x 512 with a TensorBoard window every 4:
              every TrainSummary tag (Loss, LearningRate, Throughput,
              StepTimeMs, HealthState, HBM{Total,Params,OptState,
              Activations,Transfers}MB, InfeedWaitMs, InputBoundFraction,
              MFU) at every window, HealthState 0; K1-K5 4/4/4/8/8 a
              step (``launches_observe``); the parameters' float32 bytes
              and Adam's leaves' bytes exact; saved activations <= the
              allocator's step peak, and the step's total <= the
              fit's ``max_memory_allocated`` (the script's own window:
              the accountant never resets it) <= the reserved bytes; the
              counted FLOPs a step within 1% of bench.py's formula; MFU
              within 5% of that count over StepTimeMs over the card's
              peak; the profiler's Chrome trace naming the flash kernels;
              ``trace_merge`` (the trainer's trace with the profiler's)
              holding the 16 ``train/step`` spans; ``train_cli summary``
              and ``top`` (processes) printing the MFU, HBM and health
              lines. C: a poll past ``hbm_watermark_fraction`` 0.01
              writes one forensics dump with the card's statistics, and
              allocating twice the card's memory one more through
              ``maybe_oom_forensics``. D: the step p50 with the monitor
              and accountant off and on in alternating windows, and a
              new model's first step with the FLOP counter and the
              accountant and without. B (on
              new models): ``step:nan@6`` with ``health_halt`` and a
              checkpoint every 4 steps raises ``TrainingHalted`` (halt
              step 6, a flight dump, ``latest`` = ckpt-4 with finite
              parameters), and the trainer restored there trains on with
              finite, falling losses; ``grad:nan@3`` without halt latches
              state 2 once and ``fit`` completes; ``step:nan@3`` in an
              epoch of 3 steps with a checkpoint every 2, latched by the
              epoch end's read, raises ``TrainingHalted`` with ``latest``
              = ckpt-2, finite, and the drain flag cleared. Its files, under
              ``build/chip_smoke_observe``, are deleted at the end.
16. data -- the host data layer in a context of its own.
              A: 8 batches of bench.py's BERT inputs at 32 x 512 (int32
              ids, the float32 mask and label) written as 256 TFRecord
              records and read back by the native reader with every
              checksum verified (equal to what was written); the bf16
              classifier (4 blocks) ``fit`` 2 epochs through
              ``FeatureSet.rdd(FeatureSet.array(records).transform(
              DecodeBertRecords), "DRAM")`` on 4 threads: epoch 1's
              losses equal bit for bit a ``fit`` from the same weights on
              the decoded arrays in memory, epoch 2 replays the cache (8
              hits, 8 transforms), K1-K5 4/4/4/8/8 a step
              (``launches_data``), ``InfeedWaitMs`` and
              ``InputBoundFraction`` reported. B: 2,048 uint8 3 x 256 x
              256 images in 8 npz shards; ``AugmentImages`` (a seeded 224
              crop and flip, float32, channel normalisation, cpu_bound)
              on a process pool of min(8, cpu_count) spawned workers,
              its shared-memory slots sized from ``/dev/shm``: over
              three epochs' batches in one pool, the first epoch's
              equal the serial transform's (a crc32c a batch), some
              through shared memory, and the rate once every worker has
              started is reported; the pageable against
              the pinned copy of one transformed batch; ResNet-50 bf16
              at batch 256 in alternating windows, the rows
              pre-transformed in memory against ``FeatureSet.files(
              shards).transform(AugmentImages)``: step p50, images/s,
              ``InputBoundFraction``, ``InfeedWorkers``,
              ``InfeedWorkerUtilization``, the pool's start. C: the
              pool's epoch again on 2 workers under
              ``infeed-worker:kill@3``: the worker respawns and the checksums equal the clean run's,
              complete, in order, no duplicates. Its files, under
              ``build/chip_smoke_data``, are deleted at the end.
17. detect -- image features without OpenCV and SSD object
              detection, float32, TF32 off, weights from ``--seed``. 32
              seeded images (gradients with filled rectangles, 375 x 500
              and 480 x 640) in two class folders, half baseline JPEG from
              the port's encoder, half PNG. A: ``ImageSet.read(...,
              with_label=True)`` then ``ObjectDetector(class_num=21)``
              (SSD-300, base 32, six scales, 8,744 priors; BatchNorm in
              inference) ``.predict_image_set(batch_size=8)`` on the card:
              the (8, 8744, 25) head output against the port's CPU forward
              of the same weights on the same batch, every image's (k, 6)
              rows inside its own pixels, every detection clear of its
              neighbours by 1e-4 equal to the CPU's class for class;
              images/s and the time split (decode, preprocess, forward,
              ``detection_output``), one batch's device time by kernel
              group, launches and idle share. B: ``MultiBoxLoss`` on
              ``encode_targets`` of 1-3 seeded boxes an image: the first
              step's loss and every head's gradient on the batch of 16
              against the CPU's, then ``fit`` for 4 steps at batch 16
              (the first loss the card step's, every loss finite, every
              gradient finite after step 1; the step p50 and the leg's
              own peak memory). C: ``ImageClassifier(
              "resnet-50", 10).predict_image_set`` through
              ``imagenet_preprocess``: ``clses``/``probs`` on every image,
              one image's pre-softmax logits (within 1e-4 of their scale)
              and probabilities against the CPU. D: every file
              decoded again from disk equal to what was written (PNG) or
              to the in-memory decode of its bytes (JPEG); the committed
              progressive, cut-progressive, CMYK, YCCK and progressive
              CMYK JPEGs (``tools/codec_fixtures``) to OpenCV's pixels
              (the SHA-256 ``tools/make_codec_fixtures.py`` recorded), and
              seeded Adam7-interlaced PNGs (RGB 8-bit, grey 16-bit, 1 x 1
              to 96 x 128) to their pixels; whether ``cv2`` is importable
              there is printed, it is never imported. K1-K5
              are launched 0 times in the phase. Its files, under
              ``build/chip_smoke_detect``, are deleted at the end.
18. layers -- (last) the rest of the layer library. A: bench.py's
              classifier with every block's MLP a ``SparseMoE``
              (``BERT(moe_experts=8, moe_top_k=2)``, capacity factor
              1.25; weights from ``--seed``) through ``fit`` in bf16 at
              32 x 512 (int32 ids), dropout 0.1, Adam 1e-4, 8 steps:
              K1-K5 12/12/12/24/24 a step (``launches_layers``), the
              losses finite and falling, float32 parameters and moments;
              the first step's routing of every block against the CPU's
              from the same bf16 rows (every token whose top-2 gates
              clear the next and each other by 1e-2 routed alike), the
              drop counter (telemetry on for that step) equal to the
              recount from the card's gates; a float32 dropout-off step
              on 2 rows against the CPU; the step timed (p50, tokens/s,
              peak memory, dropped share) and profiled (idle share, the
              device time split by the ``moe/*`` scopes and backward
              nodes: router, gather/scatter, expert products, K1-K5).
              B: two ``ConvLSTM2D(64, 3)`` and a sigmoid convolution on
              10 frames of 1 x 64 x 64 (Moving MNIST's shape; a seeded
              moving square) at batch 16, float32 and bf16: the first
              step on 2 rows against the CPU, 4 falling ``fit`` steps.
              C: a BiLSTM-CRF tagger at Lample et al.'s widths
              (embedding 100, LSTM 100 a direction, CoNLL-2003's 9
              tags) with ``CRFLoss`` over masked sequences of up to 64
              tokens at batch 32: 4 falling ``fit`` steps; Viterbi on
              the card equal to the CPU's where the best path beats the
              second by 1e-3. D: every new layer forward and backward
              on the card against the CPU at small sizes, float32 and
              bf16 (Deconvolution2D at strides 1-3, kernels 2 and 3,
              both border modes). K1-K5 are launched 0 times in B-D.
19. parallel -- data and sequence parallelism through the launcher
              (``python -m analytics_zoo_tpu_torch.launcher.cli`` runs
              this script as each rank, ``--parallel-worker``), all on
              the BERT-base classifier at full width, 32 x 512. In the
              script's process first: the bf16 fit of 4 steps (dropout
              0.1, Adam) and one float32 step, dropout off, whose loss and
              gradients the ranks read. A: one rank over NCCL: the same
              4-step fit, bit for bit equal to the in-process losses, a
              sharded checkpoint at step 2, and steps 3-4 resumed from it
              in a new process bit for bit equal; K1-K5 12/12/12/24/24 a
              step. B: two ranks sharing the card over gloo (NCCL refuses
              two ranks on one GPU), data_parallel=2 and ZeRO-1: the
              float32 step's loss within 1e-5 and each rank's gradient
              blocks within 1e-3 of the in-process step's, 2 bf16 steps
              (K1-K5 12/12/12/24/24 a step on each rank at B = 16), the
              collective contract, each rank's Adam moment bytes against
              leg A's. C: two ranks sharing the card, sequence_parallel=2,
              in Ulysses mode (K1-K3 at (32, 512, 6, 64), 12/12/12 a
              step) and then ring mode (K1-K3 0), each with the float32
              gate and bf16 steps, K4/K5 24/24 a step. Each leg: the step
              p50, the collective time a step by kind from the profiler,
              each rank's peak memory, the backend and the collectives
              gloo carried through host memory. The gloo legs' times are
              of two ranks sharing one card through the host, not of
              NVLink. Then in the script's process one float32 step of
              the classifier and of its MoE variant at B = 8 rows, whose
              losses and gradients legs D-G read; legs D-G run in leg B
              and C's launch, after them, each in its own context: D tensor parallelism (model_parallel=2: K1-K3 on 6
              heads a rank), E pipeline parallelism (pipeline_parallel=2,
              4 microbatches of 2 rows: K1-K5 24/24/24/48/48 a step), F
              expert parallelism (expert_parallel=2 on the MoE BERT-base,
              8 experts, top 2), G FSDP (data_parallel=2,
              param_sharding="fsdp", ZeRO-1's gspmd mode). Each: the
              float32 step's loss within 1e-5 and each rank's gradient
              blocks within 1e-3 of the in-process step's, 2 bf16 steps
              (dropout 0.1) with the ranks' losses equal and K1-K5's
              launches a step checked, the step p50 and collectives by
              kind, each rank's peak memory and its parameters' and
              Adam moments' bytes against the whole model's.
20. interop -- (run before ``parallel``) foreign models through the
              importers. A: the native ResNet-50 (``ImageClassifier(1000,
              "resnet-50")``, weights from ``--seed``) exported with the
              port's ONNX builder as opset 13 (Conv, BatchNormalization,
              Relu, MaxPool, Add, GlobalAveragePool, Flatten, Gemm,
              Softmax) and loaded by ``InferenceModel().load_onnx``: its
              rows of 2 batches of 16 x 3 x 224 x 224 within 1e-4 of the
              native ``predict``'s on the card and of its own CPU run on
              2 rows; ``load_onnx(quantize=True)`` on the card and on the
              CPU with equal int8 kernels (54) and rows within 1e-4;
              records/s, the native model's beside it, and load seconds.
              B: the same weights written in the published
              ``ResNet-50-deploy.prototxt`` layout (BatchNorm + Scale,
              Eltwise, ceil-mode pool1) and a caffemodel of packed blobs,
              through ``load_caffe``, the same gates (no int8 kernels: a
              blob's name holds no kernel key). K1-K5 launched 0 times
              in A-B. C: bench.py's classifier with its Dense(2) head a
              ``TorchNet(nn.Linear(768, 2))`` under a ``TorchCriterion``,
              ``fit`` in bf16 at 32 x 512 (int32 ids, dropout 0.1) for 4
              steps: K1-K5 12/12/12/24/24 a step (``launches_interop``),
              each loss within 2e-2 relative of the native head's from
              the same weights, a finite nonzero gradient on the torch
              module's weight and the weight moved on the card; both
              heads' step p50s from alternating windows.
              D: the same native ResNet-50 written by the public
              ``export_tf`` (a SavedModel without variables, no
              TensorFlow) and loaded back by ``InferenceModel().load_tf``:
              its rows of the 2 batches of 16 within 1e-4 of the native
              rows and of its own CPU run; records/s against native,
              write and load seconds, file MB, the graph's op set.
              E: a graph TensorFlow wrote (``tools/tf_fixtures``, checked
              against the SHA-256 of its manifest) through
              ``Net.load_tf``: rows within 1e-4 of TensorFlow's committed
              rows; one training step of it as a ``TFNet`` layer under a
              Dense(3) head on the card and on the CPU from the same
              weights: loss within 1e-5, each parameter's gradient within
              1e-4 of its norm. K1-K5 launched 0 times in D-E.
              ``python3 chip_smoke.py --phase interop`` runs the phase
              alone.
21. estimators -- (run before ``parallel``) A: ``NNClassifier`` over
              bench.py's classifier on a dict of columns (tokens,
              positions, segments, mask; 128 rows of 512 int32 ids,
              assembled into a ``features`` column), ``fit`` in bf16 at
              batch 32, dropout 0.1, Adam 1e-4, 4 steps: K1-K5
              12/12/12/24/24 a step (``launches_estimators``); a
              dropout-off float32 step's loss within 1e-6 relative of
              ``Model.fit``'s on the same rows from the same weights;
              ``transform``'s classes and an ``NNModel``'s rows equal to
              ``predict``'s; ``NNClassifierModel.save`` then
              ``NNModel.load`` giving equal rows; ``LocalEstimator``'s 2
              steps lowering the batch's loss; the NNFrames and
              ``Model.fit`` steps from alternating windows. B: a causal
              ``TransformerLayer`` at EleutherAI pythia-2.8b's width
              (hidden 2560, 32 heads of d = 80, 2048 positions, vocab
              50304; 2 of its 32 blocks) and a Dense(2) head, ``fit`` 2
              steps at 4 x 2048, float32: K1-K5 launched 0 times (d = 80
              and D = 2560 are declined); one block's dq, dk, dv at (4,
              2048, 32, 80) through the blockwise backward within 1e-4
              of autograd through ``attention_reference``, with the peak
              memory of the new Function, of autograd through the
              forward's ops and of the reference. C: the classifier at 32
              x 512 under ``ZooConfig.flash_remat = "full"``, float32,
              dropout 0.1: K1-K5 12/0/0/24/24 a step
              (``launches_remat_full``), every parameter's gradient within
              1e-4 of the default policy's from the same weights and
              masks, 2 ``fit`` steps, both policies' step p50 and peak
              memory from alternating windows. D: a ``RayContext`` of 2
              spawned workers on the card (the default platform): tasks
              return products computed on the card, equal to the
              script's; an actor keeps a running sum on the card; then
              ``automl/smoke.py``'s contract with real
              ``LSTMForecaster`` trials: 8 trials of ASHA (rungs 1, 3, 9
              epochs) on the 2 workers, one SIGKILLed when it claims a
              segment: its segment requeued exactly once, every trial
              finalized once, one at least stopped early, the best loss
              finite; each trial's seconds and the workers' start
              seconds. Its files, under ``build/chip_smoke_estimators``,
              are deleted at the end.
22. text -- (run before ``parallel``) tfpark on the card. A:
              ``BERTClassifier(num_classes=2)`` at bench.py's width (768
              hidden, 12 blocks, 12 heads, seq 512, vocab 30522), fed by
              ``bert_input_fn`` (128 rows of 512 int32 ids with a padding
              ``input_mask``, batch 32, Adam 1e-4): one float32 step with
              dropout off whose loss is within 1e-6 relative of
              ``Model.fit``'s first step on a copy of the same network
              and the same ids; 4 bf16 ``train`` steps (dropout 0.1):
              K1-K5 12/12/12/24/24 a step (``launches_text``), all on
              bf16 tensors; ``evaluate(["accuracy"])`` finite;
              ``predict``'s rows equal to ``Model.predict``'s on the same
              weights; the estimator's and ``Model.fit``'s steps from
              alternating windows. ``BERTNER`` (9 tags) and ``BERTSQuAD``
              at 4 of the 12 blocks, one bf16 step each: K1-K5 4/4/4/8/8
              (``launches_text_heads``: both together), finite outputs of
              the right shapes. B: ``NER`` at nlp_architect's NERCRF
              defaults (word 100, char 30, tagger 100, 12 characters a
              word), ``crf_mode="pad"``, on CoNLL-2003-like batches of 32
              sentences of up to 64 words: 2 float32 steps, then
              ``predict_tags`` equal to the port's CPU run of the same
              weights and inputs, zeros past each sentence's end; K1-K5
              launched 0 times; the step p50 and one step's profile
              (idle share). C: ``GANEstimator`` on tests/test_tfpark.py's
              1-D Gaussian, 150 steps at batch 64 through
              ``TFDataset.from_ndarrays``: the generated mean within 1.0
              of 3.0, the step p50, K1-K5 0.

Then the ``{"kernels": [...]}`` summary, ``nvidia-smi``'s line, and as the
last line ``{"ok": true, "device": {...}}``. Every check raises on
failure: the script then exits non-zero and prints no result. Without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import gc
import hashlib
import importlib.util
import io
import itertools
import json
import logging
import math
import multiprocessing
import os
import queue
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import init_nncontext
from analytics_zoo_tpu_torch.common import nncontext as zoo_nncontext
from analytics_zoo_tpu_torch.common.zoo_trigger import (SeveralIteration,
                                                        ZooTrigger)
from analytics_zoo_tpu_torch.feature.common import Preprocessing, Relation
from analytics_zoo_tpu_torch.feature.feature_set import (ArrayFeatureSet,
                                                         DiskFeatureSet,
                                                         FeatureSet,
                                                         MiniBatch, Sample,
                                                         TransformStats)
from analytics_zoo_tpu_torch.feature.host_pipeline import \
    ProcessTransformPool
from analytics_zoo_tpu_torch.feature.image import ImageSet, codec
from analytics_zoo_tpu_torch.feature.infeed_worker import (flatten_batch,
                                                           slot_nbytes)
from analytics_zoo_tpu_torch.feature.tfrecord import (read_tfrecord,
                                                      write_tfrecord)
from analytics_zoo_tpu_torch.feature.text import TextFeature, TextSet
from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier
from analytics_zoo_tpu_torch.models.image.objectdetection import \
    ObjectDetector
from analytics_zoo_tpu_torch.models.image.objectdetection import \
    ssd as tssd
from analytics_zoo_tpu_torch.models.recommendation import (
    NeuralCF, SessionRecommender, UserItemFeature)
from analytics_zoo_tpu_torch.models.seq2seq import (Bridge, RNNDecoder,
                                                    RNNEncoder, Seq2seq)
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as attn
from analytics_zoo_tpu_torch.ops import fused_dropout_ln as dln
from analytics_zoo_tpu_torch.ops import kv_cache
from analytics_zoo_tpu_torch.ops import quant
from analytics_zoo_tpu_torch.ops.conv import same_pads
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (Model,
                                                            Sequential)
from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    Adagrad, Adam, get_optimizer)
from analytics_zoo_tpu_torch.pipeline.engine import (PinnedStager,
                                                     SPMDTrainer,
                                                     TrainingHalted,
                                                     TrainingPreempted,
                                                     as_device_tensor,
                                                     clear_preemption,
                                                     preemption_requested,
                                                     request_preemption)
from analytics_zoo_tpu_torch.pipeline.estimator import LocalEstimator
from analytics_zoo_tpu_torch.pipeline.nnframes import (NNClassifier,
                                                       NNClassifierModel,
                                                       NNModel)
from analytics_zoo_tpu_torch.automl import (AshaScheduler,
                                            AsyncTrialExecutor, Choice,
                                            Uniform, rolling_window,
                                            run_trial_segment,
                                            train_val_split)
from analytics_zoo_tpu_torch.automl.search import sample_config
from analytics_zoo_tpu_torch.ray import RayContext
from analytics_zoo_tpu_torch.tfpark import GANEstimator, TFDataset
from analytics_zoo_tpu_torch.tfpark.text import (BERTNER, NER,
                                                 BERTClassifier, BERTSQuAD,
                                                 bert_input_fn)
from analytics_zoo_tpu_torch.utils.tensorboard import (TrainSummary,
                                                       read_scalars)
from analytics_zoo_tpu_torch.pipeline.api.caffe import proto as caffe_proto
from analytics_zoo_tpu_torch.pipeline.api.net import (Net, TFNet,
                                                      TorchCriterion,
                                                      TorchNet)
from analytics_zoo_tpu_torch.pipeline.api.onnx import builder as onnx_builder
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             ClusterServingHelper,
                                             FileStreamQueue,
                                             InProcessStreamQueue,
                                             InputQueue, ModelRegistry,
                                             OutputQueue,
                                             RoutedClusterServing,
                                             SocketStreamQueue)
from analytics_zoo_tpu_torch.serving import cli as zoo_cli
from analytics_zoo_tpu_torch.serving.fleet import read_health
from analytics_zoo_tpu_torch.serving.shard_fabric import wait_broker_up
from analytics_zoo_tpu_torch.serving.generation import (
    ContinuousBatchScheduler, GenRequest, PrefixCache,
    SpeculativeDecodeEngine, TransformerDecodeEngine)
from analytics_zoo_tpu_torch.parallel import collectives as par_collectives
from analytics_zoo_tpu_torch.parallel import sharding as par_sharding
from analytics_zoo_tpu_torch.parallel import zero
from analytics_zoo_tpu_torch.utils import (faults, memory, profiling,
                                           serialization, telemetry)
from analytics_zoo_tpu_torch.utils.crc32c import crc32c
from analytics_zoo_tpu_torch.utils.jax_weights import (optimizer_leaves,
                                                       param_order)
from analytics_zoo_tpu_torch.utils.layer_parity import (LayerRecorder,
                                                        compare_layers)
from analytics_zoo_tpu_torch.utils.op_census import OpCensus

# bench.py's BERT-base classifier (bench.py:353-438)
BERT_CONFIG = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                   seq_len=512, intermediate_size=3072,
                   output_all_block=False)
N_CLASSES = 2
REQUESTS, BATCH, CLIENTS = 8, 8, 2
TIMED_REQUESTS = 32
MIN_LEN = 64
# training: bench.py's BERT_BATCH=32 at L=512, dropout 0.1 (hidden and
# attention), Adam at lr 1e-4 on one repeated batch
TRAIN_BATCH, TRAIN_STEPS, TRAIN_P_DROP, TRAIN_LR = 32, 8, 0.1, 1e-4
TIMED_STEPS = 5
PARITY_ROWS = 2
# the training shape of the kernels: (B, L, H, d) and (N, D) rows
TRAIN_SHAPE = (TRAIN_BATCH, 512, 12, 64)
DLN_SHAPE = (TRAIN_BATCH * 512, 768)
# the parallel phase's two ranks: Ulysses runs K1-K3 on H / 2 heads at
# full L; K4/K5 take B / 2 rows of 512 (data parallelism) or B rows of
# 512 / 2 (sequence parallelism), 8,192 rows either way
PAR_SHARDS = 2
# the parallel phase's layout legs D-G: B rows a step (every rank's under
# tensor, pipeline and expert parallelism; B / dp a rank under FSDP),
# depth cut from leg A's 32; GPipe's M microbatches of B / M rows
PAR_LAYOUT_BATCH, PAR_PIPE_MICRO = 8, 4

# Tolerances, kernel against plain version, element by element.
# K1 o: |o - ro| <= atol + rtol * |ro|. float32: the kernel sums in another
# order, 1e-4. bfloat16: both round o to bf16, and the kernel rounds p
# against its running max where the plain version uses the final max; so
# two bf16 steps at |ro| (a step is at most 2**-7 |ro|) plus a quarter
# step at unit scale (|v| ~ 1) for p's rounding. lse is float32
# arithmetic in both dtypes and is held at 1e-4 in both.
O_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -9, 2 ** -6)}
LSE_TOL = 1e-4
# K2-K5: |g - rg| <= a * max|rg| + r * |rg|. float32 (1e-5, 1e-5): the
# kernels sum in another order. bfloat16 (2**-8, 2**-6): both sides round
# the same f32 intermediates (ds, p, y, dx, ...) to bf16, and an ulp apart
# in f32 can flip a rounding: two bf16 steps at |rg| plus a half step at
# the tensor's scale. The key-bias gradient and the row statistics are
# f32 arithmetic in both dtypes (F32_TOL); dgamma/dbeta are sums over
# 16384 rows (1e-4 of the largest, 1e-5 relative).
GRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -8, 2 ** -6)}
F32_TOL = GRAD_TOL[torch.float32]
DLN_PARAM_TOL = (1e-4, 1e-5)
# the served probabilities against the port's CPU run of the same row:
# 12 blocks of f32 matmuls summed in another order (TF32 off on the card)
CPU_TOL = 1e-4
ROW_SUM_TOL = 1e-5
# the training step, dropout off, card against CPU: the loss within 1e-5;
# each parameter's gradient within 1e-3 of its norm (12 blocks forward and
# backward of f32 products and reductions summed in another order)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3

# the bf16 step, dropout off, card against the port's CPU bf16 step:
# first estimates (both sides round the same products to bf16 at other
# places: a few 2**-8 relative on the loss and on each gradient)
BF16_LOSS_TOL = 2e-2
BF16_GRAD_TOL = 5e-2
# the f32 and bf16 training steps timed in alternating windows
DTYPE_WINDOWS = 2

# bench.py's NeuralCF (bench.py:155-162, bench_ncf :262-300): MovieLens-1M's
# users and items, 5 rating classes, embeddings of 20, hidden 40/20/10,
# batch 8192, 262,144 synthetic ratings (make_data :253-259), Adam at 1e-3,
# float32 (the NCF ids are float32, and bf16 would round them: ROADMAP C4)
NCF_USERS, NCF_ITEMS, NCF_CLASSES = 6040, 3706, 5
NCF_KW = dict(user_embed=20, item_embed=20, hidden_layers=[40, 20, 10],
              include_mf=True, mf_embed=20)
NCF_BATCH, NCF_SAMPLES, NCF_TIMED_EPOCHS, NCF_WINDOWS = 8192, 262144, 2, 3
NCF_PREDICT_ROWS, NCF_RECOMMEND_FEATURES, NCF_MAX_ITEMS = 8192, 2000, 5
# the card's predictions against the port's CPU run: float32 products of
# at most 60 terms summed in another order
NCF_CPU_TOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). The
# flash kernels' products run on the tensor cores: bf16 at 989 TFLOP/s,
# float32 as three TF32 products (3xTF32, to stay float32-accurate) at
# 495/3 TFLOP/s. The dropout+add+LN kernels compute in float32 on the CUDA
# cores (67 TFLOP/s).
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
CUDA_CORE_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the flash kernels' symbols, each of which must hold tensor-core
# instructions (HGMMA: wgmma; HMMA: mma.sync) in its SASS, in all four
# instantiations (float32 and bf16, d = 64 and 128)
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel")

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    attn.KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu",
                       "analytics_zoo_tpu/ops/attention.py:378"),
    attn.DQ_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                          "analytics_zoo_tpu/ops/attention.py:556"),
    attn.DKV_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
                           "analytics_zoo_tpu/ops/attention.py:605"),
    dln.FWD_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/dropout_ln.cu",
                          "analytics_zoo_tpu/ops/fused_dropout_ln.py:59"),
    dln.BWD_KERNEL_NAME: ("analytics_zoo_tpu_torch/ops/csrc/dropout_ln.cu",
                          "analytics_zoo_tpu/ops/fused_dropout_ln.py:80"),
}


def check_tensor_cores(sass):
    """Every instantiation of the flash kernels holds tensor-core
    instructions in its SASS."""
    for name in TENSOR_CORE_KERNELS:
        found = {sym: n for sym, n in sass.items() if name in sym}
        if len(found) != 4 or any(sum(n.values()) == 0
                                  for n in found.values()):
            raise AssertionError(f"{name}: tensor-core instructions by "
                                 f"instantiation {found}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, with CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn, iters, attempts: int = 3):
    """torch.profiler's CUDA kernel records over ``iters`` calls of ``fn``
    after 3 warm-up calls. The profiler now and then records no kernel at
    all in a window (seen once on the H100 in a run of this script); such
    a window is profiled again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def kernel_ms(fn, symbols, iters: int = 20):
    """Mean device time of one launch of each named kernel (a substring of
    its symbol) over ``iters`` calls of ``fn``."""
    total = {s: [0.0, 0] for s in symbols}
    for evt in _device_events(fn, iters):
        for s in symbols:
            if s in evt.key:
                total[s][0] += evt.self_device_time_total / 1e3
                total[s][1] += evt.count
    missing = [s for s, (_, n) in total.items() if n == 0]
    if missing:
        raise AssertionError(f"torch.profiler recorded no launch of "
                             f"{missing}")
    return {s: ms / n for s, (ms, n) in total.items()}


def device_ms(fn, iters: int = 10):
    """Mean device busy time of one call of ``fn``: the sum of every CUDA
    kernel's time over ``iters`` calls, divided by ``iters``. Unlike CUDA
    events around the calls it leaves out the gaps while the host
    enqueues, so a call of many small kernels is not timed at the host's
    speed."""
    busy = sum(evt.self_device_time_total
               for evt in _device_events(fn, iters))
    if busy == 0:
        raise AssertionError("torch.profiler recorded no device time")
    return busy / 1e3 / iters


def bound_ms(nbytes, ops, peak_flops):
    """The least time for ``nbytes`` moved and ``ops`` done at the card's
    published peaks (``peak_flops`` operations a second): (ms, what bounds
    it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / peak_flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def over_limit(got, want, tol):
    """(max |got - want|, max of |got - want| over the GRAD_TOL-style
    limit a * max|want| + r * |want|)."""
    a, r = tol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = a * want.abs().max() + r * want.abs()
    return diff.max().item(), (diff / limit.clamp_min(1e-30)).max().item()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def qkv_views(b, lq, lk, h, d, dtype, device, gen):
    """q, k, v as the strided (B, L, H, d) views of one fused projection,
    the way the transformer block hands them to the kernels."""
    lmax = max(lq, lk)
    qkv = torch.randn(b, lmax, 3 * h * d, device=device, generator=gen) \
        .to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    return (q[:, :lq].reshape(b, lq, h, d), k[:, :lk].reshape(b, lk, h, d),
            v[:, :lk].reshape(b, lk, h, d))


#: the key bias of a generation prefill (``TransformerLayer.prefill``)
PREFILL_BIAS = "prefill -1e9"


def key_bias(b, lk, padded, device, gen):
    """BERT's padding bias: noise on the kept keys and -10000 on a ragged
    tail of padding keys per row; zeros when ``padded`` is false. With
    ``padded == PREFILL_BIAS``, a generation prefill's: 0 on each
    prompt's keys and -1e9 past its seeded length, the longest row
    unpadded."""
    if not padded:
        return torch.zeros(b, lk, device=device)
    kb = 0.5 * torch.randn(b, lk, device=device, generator=gen)
    lengths = torch.randint(1, lk + 1, (b,), device=device, generator=gen)
    keys = torch.arange(lk, device=device)[None, :]
    if padded == PREFILL_BIAS:
        lengths[0] = lk
        kb = torch.zeros_like(kb)
        return torch.where(keys < lengths[:, None], kb,
                           torch.full_like(kb, -1e9))
    return torch.where(keys < lengths[:, None], kb,
                       torch.full_like(kb, -10000.0))


# (name, b, lq, lk, h, d, causal, key bias)
KERNEL_CASES = [
    ("train_shape", TRAIN_BATCH, 512, 512, 12, 64, False, True),
    ("bert_base", BATCH, 512, 512, 12, 64, False, True),
    ("causal_square", 2, 512, 512, 12, 64, True, False),
    ("causal_lq_lt_lk", 2, 128, 512, 12, 64, True, False),
    ("ragged_300", 2, 300, 300, 12, 64, False, True),
    ("head_dim_128", 2, 512, 512, 6, 128, True, True),
    ("decode_row", 2, 1, 77, 12, 64, True, True),
    # a partial last key tile at every streamed tile size (64 keys in
    # bf16, 32 in float32) and a partial q tile, at d=64 and d=128
    ("ragged_77", 2, 77, 77, 12, 64, False, True),
    ("ragged_77_d128", 2, 77, 77, 6, 128, False, True),
    # a batched join's prefill: causal at a ragged length with the
    # generation path's -1e9 padding bias
    ("join_prefill_300", 4, 300, 300, 12, 64, True, PREFILL_BIAS),
    # the parallel phase's Ulysses shape: every head-split rank at full L
    ("ulysses_train_shape", TRAIN_BATCH, 512, 512, 12 // PAR_SHARDS, 64,
     False, True),
    # leg D's: a tensor-parallel rank's H / 2 heads at B = 8
    ("tp_leg_shape", PAR_LAYOUT_BATCH, 512, 512, 12 // PAR_SHARDS, 64,
     False, True),
]
# the backward's cases: the forward's, less the serving and generation
# shapes, plus causal tile edges at d=128 and causal Lq < Lk with a wide
# offset
BWD_CASES = [c for c in KERNEL_CASES
             if c[0] not in ("bert_base", "decode_row",
                             "join_prefill_300")] + [
    ("causal_ragged_200_d128", 2, 200, 200, 6, 128, True, True),
    ("causal_64_lt_320", 2, 64, 320, 12, 64, True, True),
]
# (name, rows, features, keep); D = 770 is off the backward's 16-byte
# chunk (4 float32 or 8 bf16 values), so its rows start off 16-byte
# boundaries and the backward takes one value a chunk
DLN_CASES = [("train_shape",) + DLN_SHAPE + (1.0 - TRAIN_P_DROP,),
             ("parallel_rank_rows", DLN_SHAPE[0] // PAR_SHARDS,
              DLN_SHAPE[1], 1.0 - TRAIN_P_DROP),
             # leg E's: one GPipe microbatch, B / M rows of 512
             ("pipeline_micro_rows", PAR_LAYOUT_BATCH // PAR_PIPE_MICRO *
              512, DLN_SHAPE[1], 1.0 - TRAIN_P_DROP),
             ("ragged", 300, 1000, 0.75),
             ("off_vector_width", 301, 770, 0.8)]


def check_forward(device, seed):
    """K1, every case in f32 and bf16: the kernel against its plain
    version, and a second call on the same inputs bit for bit equal to
    the first. Returns {dtype: max |do| at the training shape}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, lq, lk, h, d, causal, padded in KERNEL_CASES:
            q, k, v = qkv_views(b, lq, lk, h, d, dtype, device, gen)
            kb = key_bias(b, lk, padded, device, gen)
            o, lse = attn.flash_forward_blhd(q, k, v, kb, causal)
            again = attn.flash_forward_blhd(q, k, v, kb, causal)
            torch.cuda.synchronize()
            deterministic = torch.equal(o, again[0]) and \
                torch.equal(lse, again[1])
            ro, rl = attn.flash_forward_reference(q, k, v, kb, causal,
                                                  1.0 / math.sqrt(d))
            atol, rtol = O_TOL[dtype]
            diff = (o.float() - ro.float()).abs()
            err_o = diff.max().item()
            o_over_limit = (diff / (atol + rtol * ro.float().abs())) \
                .max().item()
            err_lse = (lse - rl).abs().max().item()
            emit("kernels", kernel=attn.KERNEL_NAME, case=name,
                 dtype=dtype_name(dtype),
                 shape=dict(B=b, Lq=lq, Lk=lk, H=h, d=d), causal=causal,
                 key_bias=padded, max_abs_err_o=err_o,
                 o_tol=dict(atol=atol, rtol=rtol),
                 max_o_err_over_limit=o_over_limit,
                 max_abs_err_lse=err_lse, lse_tol=LSE_TOL,
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls of the "
                                     f"forward on the same inputs differ")
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"{name} {dtype}: non-finite output")
            if o_over_limit > 1.0 or err_lse > LSE_TOL:
                raise AssertionError(
                    f"{name} {dtype}: kernel disagrees with its plain "
                    f"version (o {err_o}, {o_over_limit} x its limit; "
                    f"lse {err_lse}, tol {LSE_TOL})")
            if name == "train_shape":
                errs[dtype] = err_o
    return errs


def check_backward(device, seed):
    """K2 and K3, every case in f32 and bf16, on the plain forward's o
    and lse: the kernels against the plain backward, and a second call on
    the same inputs bit for bit equal to the first. Returns {dtype:
    {"dq": max err, "dkv": max err over dk, dv, dbias}} at the training
    shape."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, lq, lk, h, d, causal, padded in BWD_CASES:
            q, k, v = qkv_views(b, lq, lk, h, d, dtype, device, gen)
            kb = key_bias(b, lk, padded, device, gen)
            scale = 1.0 / math.sqrt(d)
            o, lse = attn.flash_forward_reference(q, k, v, kb, causal, scale)
            do = torch.randn(b, lq, h, d, device=device, generator=gen) \
                .to(dtype)
            got = attn.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
            again = attn.flash_backward_blhd(q, k, v, kb, o, lse, do, causal)
            torch.cuda.synchronize()
            deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
            want = attn.flash_backward_reference(q, k, v, kb, o, lse, do,
                                                 causal, scale)
            tols = [GRAD_TOL[dtype]] * 3 + [F32_TOL]
            res = {n: over_limit(g, w, t) for n, g, w, t in
                   zip(("dq", "dk", "dv", "dbias"), got, want, tols)}
            emit("kernels", kernel=f"{attn.DQ_KERNEL_NAME}+"
                 f"{attn.DKV_KERNEL_NAME}", case=name,
                 dtype=dtype_name(dtype),
                 shape=dict(B=b, Lq=lq, Lk=lk, H=h, d=d), causal=causal,
                 key_bias=padded,
                 max_abs_err={n: e for n, (e, _) in res.items()},
                 max_err_over_limit={n: r for n, (_, r) in res.items()},
                 max_abs_ref={n: w.abs().max().item() for n, w in
                              zip(res, want)},
                 tol=dict(grads=GRAD_TOL[dtype], dbias=F32_TOL),
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls of the "
                                     f"backward on the same inputs differ")
            for n, g in zip(res, got):
                if not torch.isfinite(g.float()).all() or res[n][1] > 1.0:
                    raise AssertionError(
                        f"{name} {dtype}: {n} disagrees with the plain "
                        f"backward ({res[n][0]}, {res[n][1]} x its limit)")
            if name == "train_shape":
                errs[dtype] = {"dq": res["dq"][0],
                               "dkv": max(res[n][0] for n in
                                          ("dk", "dv", "dbias"))}
    return errs


def check_autograd(device, seed):
    """torch.autograd.grad through flash_attention_blhd at the training
    shape (it must run K1, K2 and K3) against the plain backward on the
    kernel forward's o and lse."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    b, l, h, d = TRAIN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach().requires_grad_() for t in
                   qkv_views(b, l, l, h, d, dtype, device, gen))
        kb = key_bias(b, l, True, device, gen)
        do = torch.randn(b, l, h, d, device=device, generator=gen).to(dtype)
        before = _kernels.LAUNCHES.snapshot()
        out = attn.flash_attention_blhd(q, k, v, bias=kb[:, None, None, :])
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        after = _kernels.LAUNCHES.snapshot()
        ran = {n: after.get(n, 0) - before.get(n, 0) for n in
               (attn.KERNEL_NAME, attn.DQ_KERNEL_NAME, attn.DKV_KERNEL_NAME)}
        o, lse = attn.flash_forward_blhd(q.detach(), k.detach(), v.detach(),
                                         kb)
        want = attn.flash_backward_reference(
            q.detach(), k.detach(), v.detach(), kb, o, lse, do, False,
            1.0 / math.sqrt(d))
        res = {n: over_limit(g, w, GRAD_TOL[dtype]) for n, g, w in
               zip(("dq", "dk", "dv"), grads, want)}
        emit("kernels", kernel="flash_attention_blhd autograd",
             case="train_shape", dtype=dtype_name(dtype), launches=ran,
             max_abs_err={n: e for n, (e, _) in res.items()},
             max_err_over_limit={n: r for n, (_, r) in res.items()},
             tol=GRAD_TOL[dtype])
        if any(n != 1 for n in ran.values()):
            raise AssertionError(f"autograd ran kernels {ran}")
        if any(r > 1.0 for _, r in res.values()):
            raise AssertionError(f"autograd gradients disagree: {res}")


def dln_inputs(n, d, dtype, device, gen):
    x = torch.randn(n, d, device=device, generator=gen).to(dtype)
    r = torch.randn(n, d, device=device, generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(d, device=device, generator=gen)
    beta = 0.1 * torch.randn(d, device=device, generator=gen)
    bits = dln.draw_bits((n, d), gen, device)
    dy = torch.randn(n, d, device=device, generator=gen).to(dtype)
    return x, r, gamma, beta, bits, dy


def check_dln(device, seed):
    """K4 and K5, every case in f32 and bf16, on the same bits: the
    kernels against their plain versions, and second calls on the same
    inputs bit for bit equal to the first. Returns {dtype: {"fwd": max
    err, "bwd": max err}} at the training shape."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, d, keep in DLN_CASES:
            x, r, gamma, beta, bits, dy = dln_inputs(n, d, dtype, device,
                                                     gen)
            got_f = dln.dln_forward(x, r, bits, gamma, beta, keep)
            again_f = dln.dln_forward(x, r, bits, gamma, beta, keep)
            torch.cuda.synchronize()
            want_f = dln.dln_forward_reference(x, r, bits, gamma, beta, keep,
                                               1e-5)
            _, z, mean, inv = want_f
            got_b = dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
            again_b = dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
            torch.cuda.synchronize()
            deterministic = all(torch.equal(a, b_) for a, b_ in
                                zip(got_f + got_b, again_f + again_b))
            want_b = dln.dln_backward_reference(dy, z, bits, gamma, mean,
                                                inv, keep)
            tols = [GRAD_TOL[dtype]] * 2 + [F32_TOL] * 2 + \
                [GRAD_TOL[dtype]] * 2 + [DLN_PARAM_TOL] * 2
            names = ("y", "z", "mean", "inv", "dx", "dres", "dgamma",
                     "dbeta")
            res = {nm: over_limit(g, w, t) for nm, g, w, t in
                   zip(names, got_f + got_b, want_f + want_b, tols)}
            emit("kernels", kernel=f"{dln.FWD_KERNEL_NAME}+"
                 f"{dln.BWD_KERNEL_NAME}", case=name,
                 dtype=dtype_name(dtype), shape=dict(N=n, D=d), keep=keep,
                 max_abs_err={nm: e for nm, (e, _) in res.items()},
                 max_err_over_limit={nm: q for nm, (_, q) in res.items()},
                 tol=dict(values=GRAD_TOL[dtype], stats=F32_TOL,
                          dgamma_dbeta=DLN_PARAM_TOL),
                 repeat_bitwise_equal=deterministic)
            if not deterministic:
                raise AssertionError(f"{name} {dtype}: two calls on the "
                                     f"same inputs differ")
            for nm, g in zip(names, got_f + got_b):
                if not torch.isfinite(g.float()).all() or res[nm][1] > 1.0:
                    raise AssertionError(
                        f"{name} {dtype}: {nm} disagrees with the plain "
                        f"version ({res[nm][0]}, {res[nm][1]} x its limit)")
            if name == "train_shape":
                errs[dtype] = {
                    "fwd": max(res[nm][0] for nm in names[:4]),
                    "bwd": max(res[nm][0] for nm in names[4:])}
    return errs


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def build_classifier(seed, config=BERT_CONFIG):
    """bench.py's classifier: BERT -> pooled -> Dense(2, softmax)."""
    l = config["seq_len"]
    ins = [L.Input(shape=(l,), name="tokens"),
           L.Input(shape=(l,), name="positions"),
           L.Input(shape=(l,), name="segments"),
           L.Input(shape=(1, 1, l), name="mask")]
    _, pooled = L.BERT(**config)(ins)
    return Model(ins, L.Dense(N_CLASSES, activation="softmax")(pooled),
                 seed=seed)


def make_requests(seed, n, batch, config=BERT_CONFIG, min_len=MIN_LEN):
    """n request batches of [tokens, positions, segments, mask] as float32
    numpy, with seeded lengths in [min_len, L]; segment 1 covers the
    second half of each sequence, and padding is masked out."""
    rs = np.random.default_rng(seed)
    l = config["seq_len"]
    requests, real_tokens = [], 0
    for _ in range(n):
        lengths = rs.integers(min_len, l + 1, size=batch)
        real_tokens += int(lengths.sum())
        pos = np.arange(l)[None, :]
        requests.append([
            rs.integers(0, config["vocab"], size=(batch, l))
            .astype(np.float32),
            np.repeat(pos.astype(np.float32), batch, axis=0),
            (pos >= lengths[:, None] // 2).astype(np.float32),
            (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]])
    return requests, real_tokens


def serve(im, requests, clients):
    """Answer ``requests`` from ``clients`` threads; returns the outputs
    and each request's latency (host clock around predict and a device
    synchronize) and the wall time of the whole run."""
    outputs = [None] * len(requests)
    latency = [None] * len(requests)

    def client(c):
        for i in range(c, len(requests), clients):
            t0 = time.perf_counter()
            out = im.predict(requests[i])
            torch.cuda.synchronize()
            latency[i] = time.perf_counter() - t0
            outputs[i] = out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        for fut in [pool.submit(client, c) for c in range(clients)]:
            fut.result()
    return outputs, latency, time.perf_counter() - t0


def check_outputs(outputs, batch):
    worst = 0.0
    for i, out in enumerate(outputs):
        if out.shape != (batch, N_CLASSES) or not np.isfinite(out).all():
            raise AssertionError(f"request {i}: bad output {out.shape}")
        worst = max(worst, float(np.abs(out.sum(-1) - 1.0).max()))
    if worst > ROW_SUM_TOL:
        raise AssertionError(f"rows do not sum to 1 (off by {worst})")
    return worst


def check_cpu_row(cpu_model, request, served_row):
    """The first row of a request through the port's CPU run (plain
    versions) against the probabilities the card served."""
    launches = _kernels.LAUNCHES.snapshot()
    with torch.inference_mode():
        cpu = cpu_model([torch.from_numpy(x[:1].copy()) for x in request])
    if _kernels.LAUNCHES.snapshot() != launches:
        raise AssertionError("the CPU run launched a kernel")
    err = float(np.abs(cpu.numpy()[0] - served_row).max())
    if err > CPU_TOL:
        raise AssertionError(f"served row differs from the CPU run by "
                             f"{err} (tol {CPU_TOL})")
    return err


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p))


PORT_KERNEL_SYMBOLS = {   # symbol substring -> profile group
    "flash_fwd_kernel": "flash_fwd (port kernel)",
    "flash_bwd_dq_kernel": "flash_bwd_dq (port kernel)",
    "flash_bwd_dkv_kernel": "flash_bwd_dkv (port kernel)",
    "dln_fwd_kernel": "dln_fwd (port kernel)",
    "dln_bwd_kernel": "dln_bwd (port kernel)",
    "dln_bwd_sum_kernel": "dln_bwd (port kernel)",
}


def kernel_group(name: str) -> str:
    for symbol, group in PORT_KERNEL_SYMBOLS.items():
        if symbol in name:
            return group
    if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas",
                               "nvjet")):
        return "matmul (cuBLAS)"
    if "indexing_backward" in name:
        return "embedding gradient (index_put accumulate)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name:
        return "reduction"
    return "other"


def profile_device(fn, group_of=None, split=None):
    """Device time by kernel group (``group_of``, ``kernel_group`` by
    default) over one call of ``fn``, from ``torch.profiler``: the
    groups' sums, their shares of the call's wall time, and the device's
    idle share. None where the profiler recorded no device time. With
    ``split``, its reading of the profile goes under ``split``."""
    group_of = group_of or kernel_group
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups, other = {}, []
    for evt in prof.key_averages():
        # a record_function scope's range on the device spans kernels
        # counted on their own: not device time of its own
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False) or \
                evt.key in MOE_SCOPES:
            continue
        group = group_of(evt.key)
        g = groups.setdefault(group, {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += evt.self_device_time_total / 1e3
        g["launches"] += evt.count
        if group == "other":
            other.append((evt.self_device_time_total / 1e3, evt.key[:80]))
    busy_ms = sum(g["device_ms"] for g in groups.values())
    extra = {} if split is None else {"split": split(prof)}
    if busy_ms == 0.0:
        return dict(wall_ms=wall_us / 1e3, groups=None, idle_share=None,
                    **extra)
    for g in groups.values():
        g["share_of_wall"] = 1e3 * g["device_ms"] / wall_us
    if other:   # the largest kernels no group claimed, by name
        groups["other"]["top"] = sorted(other, reverse=True)[:3]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_ms,
                idle_share=1.0 - 1e3 * busy_ms / wall_us,
                groups=dict(sorted(groups.items(),
                                   key=lambda kv: -kv[1]["device_ms"])),
                **extra)


def flash_bound_ms(b, lq, lk, h, d, dtype):
    """The least time the card could take for one non-causal flash
    forward: q, k, v, the key bias read once, o and lse written once,
    over the memory rate; 4*B*H*Lq*Lk*d operations over the dtype's peak.
    Returns (ms, what bounds it)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * esize + \
        4 * b * lk + 4 * b * h * lq
    return bound_ms(nbytes, 4 * b * h * lq * lk * d, PEAK_FLOPS[dtype])


def time_kernel(device, seed, dtype):
    """The forward kernel, its plain version and SDPA at the serving
    shape: the kernel's device time per launch (``kernel_ms``), the plain
    version's and SDPA's device time per call (``device_ms``), and the
    same calls timed with CUDA events (``*_events_ms``) beside them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, l, h, d = BATCH, BERT_CONFIG["seq_len"], BERT_CONFIG["n_head"], \
        BERT_CONFIG["hidden_size"] // BERT_CONFIG["n_head"]
    q, k, v = qkv_views(b, l, l, h, d, dtype, device, gen)
    kb = key_bias(b, l, True, device, gen)
    scale = 1.0 / math.sqrt(d)
    mask = kb[:, None, None, :].to(dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound, bound_by = flash_bound_ms(b, l, l, h, d, dtype)
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb, False)
    plain = lambda: attn.flash_forward_reference(q, k, v, kb, False, scale)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=scale)
    return dict(
        dtype=dtype_name(dtype), shape=dict(B=b, L=l, H=h, d=d),
        ms=kernel_ms(fwd, ["flash_fwd_kernel"])["flash_fwd_kernel"],
        plain_ms=device_ms(plain), library_ms=device_ms(sdpa),
        events_ms=cuda_ms(fwd), plain_events_ms=cuda_ms(plain, iters=10),
        library_events_ms=cuda_ms(sdpa), bound_ms=bound, bound_by=bound_by)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_data(seed, n, config=BERT_CONFIG, min_len=MIN_LEN,
               ids=np.float32):
    """n rows of [tokens, positions, segments, mask] and 0/1 labels,
    lengths in [min_len, L]; the ids as ``ids`` (float32, or int32 as
    bench.py feeds BERT: bf16 would round float ids above 256), the mask
    and labels float32. The first token (a [CLS]-like id) carries the
    label, so the classifier has something to learn."""
    rs = np.random.default_rng(seed)
    l = config["seq_len"]
    lengths = rs.integers(min_len, l + 1, size=n)
    labels = rs.integers(0, N_CLASSES, size=n)
    tokens = rs.integers(1000, config["vocab"], size=(n, l))
    tokens[:, 0] = 101 + labels
    pos = np.arange(l)[None, :]
    x = [tokens.astype(ids),
         np.repeat(pos.astype(ids), n, axis=0),
         (pos >= lengths[:, None] // 2).astype(ids),
         (pos < lengths[:, None]).astype(np.float32)[:, None, None, :]]
    return x, labels.astype(np.float32), int(lengths.sum())


def check_grads(model):
    """Every parameter has a finite gradient and every block's qkv_w a
    nonzero one (the fault of slice 1 left qkv_w without any)."""
    worst = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name}: no gradient")
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: non-finite gradient")
        if name.endswith("qkv_w"):
            worst[name] = p.grad.abs().max().item()
    n_block = BERT_CONFIG["n_block"]
    if len(worst) != n_block or min(worst.values()) <= 0.0:
        raise AssertionError(f"qkv_w gradients {worst}")
    return min(worst.values())


def check_float32_state(model):
    """Every parameter, gradient and Adam moment of a trained model is
    float32 (bf16 compute keeps float32 master weights)."""
    for name, p in model.named_parameters():
        if p.dtype != torch.float32 or (p.grad is not None and
                                        p.grad.dtype != torch.float32):
            raise AssertionError(f"{name}: {p.dtype}, gradient "
                                 f"{None if p.grad is None else p.grad.dtype}")
    moments = model.trainer.opt_state[0]
    bad = [k for part in ("mu", "nu") for k, t in moments[part].items()
           if t.dtype != torch.float32]
    if bad:
        raise AssertionError(f"Adam moments not float32: {bad}")


def train(seed, compute_dtype="float32"):
    """Model.compile + Model.fit in ``compute_dtype``, TRAIN_STEPS steps on
    one batch (float32 ids in float32, int32 ids in bfloat16), with the
    launch counts and the dtypes the kernels were given read around the
    fit calls; then evaluate."""
    bf16 = compute_dtype == "bfloat16"
    config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    model = build_classifier(seed + 1, config)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.set_compute_dtype(compute_dtype)
    x, y, real_tokens = train_data(seed, TRAIN_BATCH,
                                   ids=np.int32 if bf16 else np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    losses = list(model.trainer.step_losses)
    min_qkv_grad = check_grads(model)
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    launch_dtypes = _kernels.LAUNCHES.by_dtype()
    peak = torch.cuda.max_memory_allocated()
    losses += model.trainer.step_losses
    n_block = BERT_CONFIG["n_block"]
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if launch_dtypes != {k: {compute_dtype: n} for k, n in expected.items()}:
        raise AssertionError(f"the kernels were given {launch_dtypes}, "
                             f"expected {compute_dtype} only")
    check_float32_state(model)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the loss did not fall: {losses}")
    results = model.evaluate(x, y, batch_size=TRAIN_BATCH)
    if not all(np.isfinite(v) for v in results.values()) or \
            set(results) != {"loss", "accuracy"}:
        raise AssertionError(f"evaluate gave {results}")
    return model, dict(
        model="BERT-base classifier (bench.py:353-438)", config=config,
        seed=seed, compute_dtype=compute_dtype,
        ids=dtype_name(torch.int32 if bf16 else torch.float32),
        optimizer=f"adam lr {TRAIN_LR}",
        loss="sparse_categorical_crossentropy", batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, real_tokens_per_batch=real_tokens,
        losses=losses, min_qkv_w_grad_after_step_1=min_qkv_grad,
        launches=launches, launches_per_step=per_step,
        launch_dtypes=launch_dtypes, float32_params_and_moments=True,
        fit_wall_s=wall, peak_memory_bytes=peak, evaluate=results,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32)


def check_train_parity(seed, device, compute_dtype="float32", extra=None):
    """One training step in ``compute_dtype``, dropout off, on PARITY_ROWS
    rows: the card (the flash kernels run, the dropout+add+LN kernels do
    not) against the port's CPU run (plain versions) from the same
    weights (``extra``: more of the BERT layer's config, the MoE's).
    Returns the gaps, which must lie within the dtype's limits."""
    bf16 = compute_dtype == "bfloat16"
    loss_tol, grad_tol = (BF16_LOSS_TOL, BF16_GRAD_TOL) if bf16 else \
        (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)
    config = dict(BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0,
                  **(extra or {}))
    model = build_classifier(seed + 2, config)
    cpu_model = copy.deepcopy(model)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    card = SPMDTrainer(model, loss_fn, get_optimizer("adam"), device=device,
                       compute_dtype=compute_dtype)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("adam"),
                      device="cpu", compute_dtype=compute_dtype)
    x, y, _ = train_data(seed + 2, PARITY_ROWS,
                         ids=np.int32 if bf16 else np.float32)
    batch = (x, y, np.ones(PARITY_ROWS, np.float32))
    card.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    card_loss = card.loss_and_grads(card.put_batch(batch)).item()
    launches = _kernels.LAUNCHES.snapshot()
    launch_dtypes = _kernels.LAUNCHES.by_dtype()
    n_block = BERT_CONFIG["n_block"]
    expected = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block}
    if launches != expected or any(set(v) != {compute_dtype}
                                   for v in launch_dtypes.values()):
        raise AssertionError(f"parity step launches {launch_dtypes}, "
                             f"expected {expected} in {compute_dtype}")
    t0 = time.perf_counter()
    cpu_loss = cpu.loss_and_grads(cpu.put_batch(batch)).item()
    cpu_s = time.perf_counter() - t0
    cpu_params = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        g, w = p.grad.cpu(), cpu_params[name].grad
        rel = ((g - w).norm() / max(w.norm().item(), 1e-12)).item()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient on the card")
        if rel > worst:
            worst, worst_name = rel, name
    loss_err = abs(card_loss - cpu_loss)
    res = dict(rows=PARITY_ROWS, dropout=0.0, compute_dtype=compute_dtype,
               launches=launches, card_loss=card_loss, cpu_loss=cpu_loss,
               loss_err=loss_err, loss_tol=loss_tol,
               max_grad_rel_err=worst, max_grad_rel_err_param=worst_name,
               grad_tol=grad_tol, cpu_step_s=cpu_s)
    if loss_err > loss_tol or worst > grad_tol:
        emit("train_parity", ok=False, **res)
        raise AssertionError(f"card step differs from the CPU run: loss "
                             f"{loss_err}, gradient {worst} ({worst_name})")
    return res


def flash_bwd_bounds(b, lq, lk, h, d, dtype):
    """The least time for dq and for dk/dv/dbias at a non-causal shape:
    each operand read once and each output written once (q, k, v, dO,
    lse, delta and the key bias in; dq, or dk, dv and the per-head bias
    gradient out) over the memory rate; 3 and 4 products of
    2*B*H*Lq*Lk*d operations over the dtype's peak."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows_q, rows_k = b * lq * h * d * esize, b * lk * h * d * esize
    stats = 4 * 2 * b * h * lq + 4 * b * lk
    product = 2 * b * h * lq * lk * d
    return (bound_ms(2 * rows_q + 2 * rows_k + rows_q + stats, 3 * product,
                     PEAK_FLOPS[dtype]),
            bound_ms(2 * rows_q + 4 * rows_k + stats + 4 * b * h * lk,
                     4 * product, PEAK_FLOPS[dtype]))


def dln_bounds(n, d, dtype):
    """The least time for the dropout+add+LN forward and backward: x,
    resid and the 32-bit words (or dy, z and the words) read once, y and
    z (or dx and dresid) written once, plus the row statistics, gamma and
    beta read once and the backward's dgamma and dbeta written once (the
    function's own work: no partials of any design); operations counted
    from the function's arithmetic, 9 per element forward and 14
    backward, at the float32 peak of the CUDA cores (they compute in
    f32)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows = n * d * (4 * esize + 4) + 2 * n * 4
    fwd = bound_ms(rows + 2 * d * 4, 9 * n * d, CUDA_CORE_F32_FLOPS)
    bwd = bound_ms(rows + d * 4 + 2 * d * 4, 14 * n * d,
                   CUDA_CORE_F32_FLOPS)
    return fwd, bwd


def time_training_kernels(device, seed, dtype):
    """Each kernel at the training shape: its device time per launch (from
    torch.profiler's kernel records), its bound, and the device time per
    call (``device_ms``) of its plain version and of the library call
    where there is one: SDPA forward for K1, SDPA's backward (dq, dk and
    dv together) for K2 and K3; none for K4 and K5, whose composed
    dropout + add + F.layer_norm forward and backward are timed beside
    them. The ``*_events_ms`` keys time the same calls with CUDA events
    (host enqueue gaps included)."""
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    b, l, h, d = TRAIN_SHAPE
    q, k, v = qkv_views(b, l, l, h, d, dtype, device, gen)
    kb = key_bias(b, l, True, device, gen)
    do = torch.randn(b, l, h, d, device=device, generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = attn.flash_forward_blhd(q, k, v, kb)
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb)
    bwd = lambda: attn.flash_backward_blhd(q, k, v, kb, o, lse, do)
    dev = kernel_ms(fwd, ["flash_fwd_kernel"])
    dev.update(kernel_ms(bwd, ["flash_bwd_dq_kernel",
                               "flash_bwd_dkv_kernel"]))
    mask = kb[:, None, None, :].to(dtype)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale)
    sdpa_do = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), sdpa_do, retain_graph=True)
    with torch.no_grad():
        sdpa_fwd = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale)
        sdpa_fwd_ms = device_ms(sdpa_fwd)
        sdpa_fwd_events_ms = cuda_ms(sdpa_fwd)
    plain_bwd = lambda: attn.flash_backward_reference(
        q, k, v, kb, o, lse, do, False, scale)
    bwd_plain_ms = device_ms(plain_bwd, iters=5)
    sdpa_bwd_ms = device_ms(sdpa_bwd)
    sdpa_bwd_events_ms = cuda_ms(sdpa_bwd, iters=20)
    fb = flash_bound_ms(b, l, l, h, d, dtype)
    dqb, dkvb = flash_bwd_bounds(b, l, l, h, d, dtype)
    out = {
        attn.KERNEL_NAME: dict(
            ms=dev["flash_fwd_kernel"], wrapper_events_ms=cuda_ms(fwd),
            plain_ms=device_ms(lambda: attn.flash_forward_reference(
                q, k, v, kb, False, scale)),
            library_ms=sdpa_fwd_ms, library_events_ms=sdpa_fwd_events_ms,
            library="SDPA forward", bound_ms=fb[0], bound_by=fb[1]),
        attn.DQ_KERNEL_NAME: dict(
            ms=dev["flash_bwd_dq_kernel"], plain_ms=bwd_plain_ms,
            library_ms=sdpa_bwd_ms, bound_ms=dqb[0], bound_by=dqb[1]),
        attn.DKV_KERNEL_NAME: dict(
            ms=dev["flash_bwd_dkv_kernel"], plain_ms=bwd_plain_ms,
            library_ms=sdpa_bwd_ms, bound_ms=dkvb[0], bound_by=dkvb[1]),
    }
    bwd_wrapper_ms = cuda_ms(bwd, iters=20)
    for name in (attn.DQ_KERNEL_NAME, attn.DKV_KERNEL_NAME):
        out[name].update(
            wrapper_events_ms=bwd_wrapper_ms,
            library_events_ms=sdpa_bwd_events_ms,
            note="plain_ms is the plain backward (dq, dk, dv and dbias "
                 "together); library_ms SDPA's backward (dq, dk, dv "
                 "together); wrapper_events_ms flash_backward_blhd "
                 "(delta, both kernels, the head sum)")

    n, dd = DLN_SHAPE
    keep = 1.0 - TRAIN_P_DROP
    x, r, gamma, beta, bits, dy = dln_inputs(n, dd, dtype, device, gen)
    y, z, mean, inv = dln.dln_forward(x, r, bits, gamma, beta, keep)
    dfwd = lambda: dln.dln_forward(x, r, bits, gamma, beta, keep)
    dbwd = lambda: dln.dln_backward(dy, z, bits, gamma, mean, inv, keep)
    dev = kernel_ms(dfwd, ["dln_fwd_kernel"])
    # K5 is two launches a call: the rows, then the partials' sum
    dev.update(kernel_ms(dbwd, ["dln_bwd_kernel", "dln_bwd_sum_kernel"]))
    xg, rg, gg, bg = (t.detach().clone().requires_grad_()
                      for t in (x, r, gamma.to(dtype), beta.to(dtype)))
    composed = lambda: F.layer_norm(
        F.dropout(xg, TRAIN_P_DROP, training=True) + rg, (dd,), gg, bg, 1e-5)
    yc = composed()
    composed_bwd = lambda: torch.autograd.grad(
        yc, (xg, rg, gg, bg), dy, retain_graph=True)
    with torch.no_grad():
        composed_fwd_ms = device_ms(composed)
        composed_fwd_events_ms = cuda_ms(composed, iters=20)
    fwdb, bwdb = dln_bounds(n, dd, dtype)
    out[dln.FWD_KERNEL_NAME] = dict(
        ms=dev["dln_fwd_kernel"], wrapper_events_ms=cuda_ms(dfwd, iters=20),
        plain_ms=device_ms(lambda: dln.dln_forward_reference(
            x, r, bits, gamma, beta, keep, 1e-5)),
        library_ms=None, composed_ms=composed_fwd_ms,
        composed_events_ms=composed_fwd_events_ms,
        composed="F.dropout + add + F.layer_norm forward",
        bound_ms=fwdb[0], bound_by=fwdb[1])
    out[dln.BWD_KERNEL_NAME] = dict(
        ms=dev["dln_bwd_kernel"] + dev["dln_bwd_sum_kernel"],
        rows_kernel_ms=dev["dln_bwd_kernel"],
        partial_sum_ms=dev["dln_bwd_sum_kernel"],
        wrapper_events_ms=cuda_ms(dbwd, iters=20),
        plain_ms=device_ms(lambda: dln.dln_backward_reference(
            dy, z, bits, gamma, mean, inv, keep)),
        library_ms=None, composed_ms=device_ms(composed_bwd),
        composed_events_ms=cuda_ms(composed_bwd, iters=20),
        composed="F.dropout + add + F.layer_norm backward",
        bound_ms=bwdb[0], bound_by=bwdb[1])
    return out


def time_training(model, seed):
    """Step time, padded tokens/s and peak memory of TIMED_STEPS more
    training steps on the trained model, and the device profile of one
    step."""
    trainer = model.trainer
    x, y, real_tokens = train_data(seed, TRAIN_BATCH)
    batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p50 = percentile(step_s, 50)
    l = BERT_CONFIG["seq_len"]
    return dict(
        steps=TIMED_STEPS, batch=TRAIN_BATCH, step_ms=[1e3 * s for s in
                                                      step_s],
        step_p50_ms=1e3 * p50, padded_tokens_per_s=TRAIN_BATCH * l / p50,
        real_tokens_per_s=real_tokens / p50, peak_memory_bytes=peak,
        clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                          "temperature.gpu"),
        profile=profile_device(lambda: trainer.train_step(batch)))


def time_train_dtypes(models, seed):
    """The float32 and the bf16 training step on one int32-id batch, timed
    in alternating windows of TIMED_STEPS steps (f32, bf16, bf16, f32,
    ...): each step's wall (host clock around a synchronised step), the
    p50, tokens/s and the peak memory of each window; then the bf16
    step's device time by kernel group. Both models stay on the card, so
    each peak includes the other model's weights and optimizer state."""
    x, y, real_tokens = train_data(seed, TRAIN_BATCH, ids=np.int32)
    host = (x, y, np.ones(TRAIN_BATCH, np.float32))
    batches = {dt: m.trainer.put_batch(host) for dt, m in models.items()}
    step_s = {dt: [] for dt in models}
    peaks = {dt: [] for dt in models}
    order = list(models)
    for w in range(DTYPE_WINDOWS):
        for dt in (order if w % 2 == 0 else order[::-1]):
            trainer = models[dt].trainer
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batches[dt])
                torch.cuda.synchronize()
                step_s[dt].append(time.perf_counter() - t0)
            peaks[dt].append(torch.cuda.max_memory_allocated())
    l = BERT_CONFIG["seq_len"]
    out = {}
    for dt in models:
        p50 = percentile(step_s[dt], 50)
        out[dt] = dict(step_ms=[1e3 * t for t in step_s[dt]],
                       step_p50_ms=1e3 * p50,
                       padded_tokens_per_s=TRAIN_BATCH * l / p50,
                       real_tokens_per_s=real_tokens / p50,
                       peak_memory_bytes=max(peaks[dt]))
    bf16 = models["bfloat16"].trainer
    out["bfloat16"]["profile"] = profile_device(
        lambda: bf16.train_step(batches["bfloat16"]))
    out["bf16_speedup"] = out["float32"]["step_p50_ms"] / \
        out["bfloat16"]["step_p50_ms"]
    return dict(windows=DTYPE_WINDOWS, steps_per_window=TIMED_STEPS,
                batch=TRAIN_BATCH, ids="int32", **out)


# ---------------------------------------------------------------------------
# NeuralCF
# ---------------------------------------------------------------------------

def ncf_data(seed):
    """bench.py's make_data: float32 (user, item) ids from 1 and int32
    rating classes 0-4."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, NCF_USERS + 1, NCF_SAMPLES),
                  rng.integers(1, NCF_ITEMS + 1, NCF_SAMPLES)],
                 axis=1).astype(np.float32)
    y = rng.integers(0, NCF_CLASSES, NCF_SAMPLES).astype(np.int32)
    return x, y


def windows_stats(fn, n):
    """bench.py's ``_windows_stats``: ``fn`` (one timed window -> value)
    run n times; (median, {min, median, max, n})."""
    vals = sorted(fn() for _ in range(n))
    med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
    return med, {"min": vals[0], "median": med, "max": vals[-1], "n": n}


def check_ncf_inference(ncf, seed, device):
    """``predict`` of NCF_PREDICT_ROWS rows on the card against the port's
    CPU run from the same weights, ``predict_classes`` against the CPU's
    classes, ``predict`` on an ArrayFeatureSet against the array, and
    ``recommend_for_user`` on NCF_RECOMMEND_FEATURES pairs."""
    rs = np.random.default_rng(seed + 13)
    x = np.stack([rs.integers(1, NCF_USERS + 1, NCF_PREDICT_ROWS),
                  rs.integers(1, NCF_ITEMS + 1, NCF_PREDICT_ROWS)],
                 axis=1).astype(np.float32)
    probs = ncf.predict(x, batch_size=NCF_BATCH)
    classes = ncf.predict_classes(x, batch_size=NCF_BATCH)
    on_set = ncf.predict(ArrayFeatureSet(x), batch_size=NCF_BATCH)
    cpu_model = copy.deepcopy(ncf.model)
    cpu_model.trainer = None
    cpu = SPMDTrainer(cpu_model, get_loss("sparse_categorical_crossentropy"),
                      get_optimizer("sgd"), device="cpu")
    want = cpu.predict(x, batch_size=NCF_BATCH)
    err = float(np.abs(probs - want).max())
    same_classes = bool(np.array_equal(classes, want.argmax(-1)))
    same_set = bool(np.array_equal(on_set, probs))
    # recommendations: a few hundred users, several items each
    users = rs.integers(1, 201, NCF_RECOMMEND_FEATURES)
    items = rs.integers(1, NCF_ITEMS + 1, NCF_RECOMMEND_FEATURES)
    feats = [UserItemFeature(u, i, Sample(np.array([u, i], np.float32)))
             for u, i in zip(users, items)]
    recs = ncf.recommend_for_user(feats, NCF_MAX_ITEMS)
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append(r.probability)
    ranked = all(len(p) <= NCF_MAX_ITEMS and p == sorted(p, reverse=True)
                 for p in by_user.values())
    res = dict(rows=NCF_PREDICT_ROWS, cpu_max_abs_err=err,
               cpu_tol=NCF_CPU_TOL, classes_equal_cpu=same_classes,
               feature_set_equal_array=same_set,
               recommend_features=NCF_RECOMMEND_FEATURES,
               recommend_users=len(by_user), recommendations=len(recs),
               max_items=NCF_MAX_ITEMS, recommendations_ranked=ranked)
    if probs.shape != (NCF_PREDICT_ROWS, NCF_CLASSES) or \
            not np.isfinite(probs).all() or err > NCF_CPU_TOL or \
            not same_classes or not same_set or not ranked or \
            len(by_user) != len(set(users.tolist())):
        emit("ncf", ok=False, **res)
        raise AssertionError(f"NCF inference on the card: {res}")
    return res


def ncf(seed, device):
    """bench_ncf's configuration through ``fit``, ``evaluate``,
    ``predict`` and ``recommend_for_user``, timed as bench_ncf reckons
    it: one warm-up epoch, then windows of ``fit(nb_epoch=2)`` ending in a
    host sync, each as steps over the window's wall."""
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed + 11
    model = NeuralCF(NCF_USERS, NCF_ITEMS, NCF_CLASSES, **NCF_KW)
    config.seed = seed0     # the model drew its weights from seed + 11
    model.compile(optimizer=Adam(lr=1e-3),
                  loss="sparse_categorical_crossentropy")
    x, y = ncf_data(seed + 12)
    steps_per_epoch = NCF_SAMPLES // NCF_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=1)
    warmup_s = time.perf_counter() - t0
    losses = [list(model.model.trainer.step_losses)]

    def window():
        t1 = time.perf_counter()
        model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=NCF_TIMED_EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        losses.append(list(model.model.trainer.step_losses))
        return steps_per_epoch * NCF_TIMED_EPOCHS / wall

    med, stats = windows_stats(window, NCF_WINDOWS)
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    if launches:
        raise AssertionError(f"NCF launched hand-written kernels {launches}")
    flat = [v for run in losses for v in run]
    first, last = np.mean(flat[:steps_per_epoch]), \
        np.mean(flat[-steps_per_epoch:])
    if len(flat) != steps_per_epoch * (1 + NCF_TIMED_EPOCHS * NCF_WINDOWS) \
            or not np.isfinite(flat).all() or not last < first:
        raise AssertionError(f"NCF losses: first epoch {first}, last "
                             f"{last}, {len(flat)} steps")
    results = model.evaluate(x[:NCF_PREDICT_ROWS], y[:NCF_PREDICT_ROWS],
                             batch_size=NCF_BATCH)
    if not np.isfinite(results["loss"]):
        raise AssertionError(f"NCF evaluate gave {results}")
    trainer = model.model.trainer
    batch = trainer.put_batch(next(ArrayFeatureSet(x, y).batches(
        NCF_BATCH)))
    step = lambda: trainer.train_step(batch)
    profile = profile_device(step)
    # the step alone on a batch already on the card, no sync between
    # steps as in fit: what the fit window adds is the host's batching
    # and copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_per_epoch):
        step()
    torch.cuda.synchronize()
    step_only_ms = 1e3 * (time.perf_counter() - t0) / steps_per_epoch
    step_launches = sum(g["launches"] for g in
                        (profile["groups"] or {}).values())
    inference = check_ncf_inference(model, seed, device)
    return dict(
        model="NeuralCF (bench.py bench_ncf, MovieLens-1M shape)",
        users=NCF_USERS, items=NCF_ITEMS, classes=NCF_CLASSES, **NCF_KW,
        optimizer="adam lr 0.001", loss="sparse_categorical_crossentropy",
        compute_dtype="float32", batch=NCF_BATCH, samples=NCF_SAMPLES,
        steps_per_epoch=steps_per_epoch, seed=seed,
        params=sum(p.numel() for p in model.model.parameters()),
        warmup_epoch_s=warmup_s, steps_per_s=med, steps_per_s_windows=stats,
        first_epoch_mean_loss=first, last_epoch_mean_loss=last,
        evaluate=results, hand_written_kernel_launches=launches,
        launches_per_step=step_launches, step_profile=profile,
        step_on_device_batch_ms=step_only_ms, fit_step_ms=1e3 / med,
        peak_memory_bytes=peak, inference=inference)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

# TransformerLayer's own defaults at the depth and context of GPT-1
# ("openai-gpt"): 12 blocks, 768 wide, 12 heads of 64, 512 positions;
# about 117 M parameters (469 MB in float32)
GPT_CONFIG = dict(n_block=12, hidden_size=768, n_head=12, vocab=40990,
                  seq_len=512, intermediate_size=3072)
GEN_REQUESTS, GEN_SLOTS, GEN_NEW_TOKENS = 16, 8, 48
GEN_MIN_PROMPT, GEN_MAX_PROMPT = 32, 384
FAST_REQUESTS, FAST_NEW_TOKENS, FAST_CHUNK, SPEC_K = 8, 24, 64, 3
DRAFT_BLOCKS = 2
CPU_TOKENS = 16
GEN_TIMEOUT_S = 300.0
# the card's prefill logits against the port's CPU run: 12 blocks of f32
# matmuls summed in another order (logits of scale ~1)
GEN_CPU_TOL = 1e-3
# decode_chunk against repeated decode_step on the card: the same f32
# products at other row counts
CHUNK_STEP_TOL = 1e-4
TIMED_DECODE_STEPS = 20
# (B, Lp) of the timed prefills: one long prompt alone, a batched join
PREFILL_SHAPES = ((1, 512), (4, 384))


class TimedSteps:
    """An engine whose ``step`` calls are timed on the host clock (each
    ends in the host transfer of its picks) with their gang width; every
    other attribute is the engine's."""

    def __init__(self, engine):
        self.engine = engine
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, state, feeds, temps):
        t0 = time.perf_counter()
        out = self.engine.step(state, feeds, temps)
        self.steps.append((len(feeds), time.perf_counter() - t0))
        return out


def gen_prompts(seed, n):
    rs = np.random.default_rng(seed)
    return [rs.integers(1, GPT_CONFIG["vocab"], size=int(m))
            for m in rs.integers(GEN_MIN_PROMPT, GEN_MAX_PROMPT + 1, size=n)]


def run_scheduler(engine, prompts, max_new_tokens, **kw):
    """Start a ContinuousBatchScheduler over ``engine``, submit one greedy
    request per prompt (made as it is submitted, so its TTFT starts
    there), wait for every commit and stop. Checks that each request was
    committed exactly once with ``max_new_tokens`` tokens. Returns
    (payloads by uri, the scheduler, wall seconds)."""
    out, commits, lock = {}, {}, threading.Lock()
    done = threading.Event()

    def commit(uri, payload):
        with lock:
            commits[uri] = commits.get(uri, 0) + 1
            out[uri] = payload
            if len(out) == len(prompts):
                done.set()

    sched = ContinuousBatchScheduler(engine, commit, **kw).start()
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        sched.submit(GenRequest(uri=f"g{i}", prompt=prompt,
                                max_new_tokens=max_new_tokens))
    # wait without polling: a waking thread would take the interpreter
    # lock from the scheduler thread's eager enqueue
    while not done.wait(1.0):
        if not sched._thread.is_alive():
            raise AssertionError("the scheduler thread stopped early")
        if time.perf_counter() - t0 > GEN_TIMEOUT_S:
            raise AssertionError(f"{len(out)} of {len(prompts)} requests "
                                 f"committed in {GEN_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    sched.stop(drain=True, timeout=60)
    bad = {u: (p.get("finish"), len(p.get("tokens", ())))
           for u, p in out.items()
           if p.get("finish") != "max_new_tokens" or
           len(p["tokens"]) != max_new_tokens}
    if bad or any(n != 1 for n in commits.values()) or \
            sched.counts["duplicate_commits"] or \
            sched.counts["committed"] != len(prompts):
        raise AssertionError(f"commits {commits}, bad payloads {bad}, "
                             f"counts {sched.counts}")
    return out, sched, wall


def greedy_reference(layer, prompt, n_tokens):
    """The greedy stream of one prompt through batch-1 prefill and
    decode_step, with each step's logits: (tokens, [logits rows])."""
    dev = layer.tok_emb.device
    state = layer.init_decode_state(1, GPT_CONFIG["seq_len"])
    logits, state = layer.prefill(torch.as_tensor(prompt[None], device=dev),
                                  torch.tensor([prompt.size], device=dev),
                                  state)
    tokens, rows = [], []
    for _ in range(n_tokens):
        rows.append(logits[0].float().cpu())
        tokens.append(int(torch.argmax(logits[0])))
        logits, state = layer.decode_step(
            state, torch.tensor([tokens[-1]], device=dev))
    return tokens, rows


def check_streams(name, layer, prompts, got, want):
    """Greedy streams ``got`` equal ``want`` (dicts by uri). At the first
    difference it emits the position and the plain step's top-2 logit gap
    there (from ``layer`` on the card), then fails."""
    for i, prompt in enumerate(prompts):
        uri = f"g{i}"
        a, b = got[uri], want[uri]
        if a == b:
            continue
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        _, rows = greedy_reference(layer, prompt, pos + 1)
        top2 = torch.topk(rows[pos], 2).values
        emit("generate", check=name, request=uri, ok=False,
             first_difference=pos, got=a[pos:pos + 1], want=b[pos:pos + 1],
             plain_top2_logit_gap=(top2[0] - top2[1]).item())
        raise AssertionError(f"{name}: {uri} differs at token {pos}")


def build_decoder(seed, config=None):
    config = config or GPT_CONFIG
    layer = L.TransformerLayer(**config)
    layer.build_params(torch.Generator().manual_seed(seed),
                       (None, config["seq_len"]))
    return layer.eval()


def draft_of(target):
    """A DRAFT_BLOCKS-block TransformerLayer of the target's width that
    carries its embeddings and first blocks."""
    draft = build_decoder(0, dict(GPT_CONFIG, n_block=DRAFT_BLOCKS))
    weights = target.state_dict()
    draft.load_state_dict({k: weights[k] for k in draft.state_dict()})
    return draft


def flash_causal_bound_ms(b, l, h, d, dtype):
    """The least time for one causal flash forward at Lq = Lk = l: the
    operands read and o and lse written once over the memory rate; the
    two products over the l(l+1)/2 visible (query, key) pairs over the
    dtype's peak."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * l * h * d * esize + 4 * b * l + 4 * b * h * l
    return bound_ms(nbytes, 4 * b * h * d * l * (l + 1) // 2,
                    PEAK_FLOPS[dtype])


def time_prefill_kernel(device, seed, b, l):
    """K1 at a prefill shape, causal with the -1e9 padding bias, float32:
    its device time per launch, the plain version's and SDPA's (the bias
    and the causal mask folded into one float mask) device time per call,
    and its bound."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = GPT_CONFIG["n_head"]
    d = GPT_CONFIG["hidden_size"] // h
    q, k, v = qkv_views(b, l, l, h, d, torch.float32, device, gen)
    kb = key_bias(b, l, PREFILL_BIAS, device, gen)
    scale = 1.0 / math.sqrt(d)
    causal = torch.ones(l, l, dtype=torch.bool, device=device).tril()
    mask = torch.where(causal, kb[:, None, None, :],
                       torch.full((), -math.inf, device=device))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = lambda: attn.flash_forward_blhd(q, k, v, kb, True)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=scale)
    bound, bound_by = flash_causal_bound_ms(b, l, h, d, torch.float32)
    return dict(shape=dict(B=b, L=l, H=h, d=d), causal=True,
                key_bias=PREFILL_BIAS,
                ms=kernel_ms(fwd, ["flash_fwd_kernel"])["flash_fwd_kernel"],
                plain_ms=device_ms(lambda: attn.flash_forward_reference(
                    q, k, v, kb, True, scale)),
                library_ms=device_ms(sdpa), library="SDPA, float mask",
                bound_ms=bound, bound_by=bound_by)


def generate_main_run(layer, seed, device, smi):
    """The main run: GEN_REQUESTS greedy requests through the scheduler
    on GEN_SLOTS slots, with the launches read around it; then the first
    request against the port's CPU run. Returns K1's launches."""
    t0 = time.perf_counter()
    cpu_layer = copy.deepcopy(layer)
    engine = TimedSteps(TransformerDecodeEngine(layer))
    if engine.device != device:
        raise AssertionError(f"the engine chose {engine.device}")
    setup_s = time.perf_counter() - t0
    # warm-up: one short request, so the main run's first join does not
    # pay for first-call set-up
    run_scheduler(engine, gen_prompts(seed + 6, 1), 4, max_slots=GEN_SLOTS)
    engine.steps.clear()

    prompts = gen_prompts(seed + 7, GEN_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0 = engine.prefill_calls
    _kernels.LAUNCHES.reset()
    out, sched, wall = run_scheduler(engine, prompts, GEN_NEW_TOKENS,
                                     max_slots=GEN_SLOTS, prefill_chunk=0)
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    prefill_calls = engine.prefill_calls - calls0
    expected = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * prefill_calls}
    if launches != expected:
        raise AssertionError(f"generate launches {launches}, expected "
                             f"{expected} ({prefill_calls} prefills)")
    ttft = [p["timing"]["ttft_ms"] for p in out.values()]
    full_gang = [dt for n, dt in engine.steps if n == GEN_SLOTS]
    first = out["g0"]["tokens"][:CPU_TOKENS]

    # the first request against the port's CPU run: prefill logits and
    # the first CPU_TOKENS greedy tokens
    _, card_rows = greedy_reference(layer, prompts[0], 1)
    launches_cpu = _kernels.LAUNCHES.snapshot()
    cpu_tokens, cpu_rows = greedy_reference(cpu_layer, prompts[0],
                                            CPU_TOKENS)
    if _kernels.LAUNCHES.snapshot() != launches_cpu:
        raise AssertionError("the CPU run launched a kernel")
    cpu_err = (card_rows[0] - cpu_rows[0]).abs().max().item()
    emit("generate", check="main run",
         model="TransformerLayer, GPT-1 (openai-gpt) depth and context",
         config=GPT_CONFIG, seed=seed + 5, setup_s=setup_s,
         requests=GEN_REQUESTS, max_slots=GEN_SLOTS,
         max_new_tokens=GEN_NEW_TOKENS,
         prompt_lengths=[int(p.size) for p in prompts],
         prefill_calls=prefill_calls, launches=launches,
         launches_expected=expected, joins=sched.counts["joins"],
         capacity=sched.stats()["capacity"], wall_s=wall,
         tokens_per_s=GEN_REQUESTS * GEN_NEW_TOKENS / wall,
         ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
         decode_steps=len(engine.steps), full_gang_steps=len(full_gang),
         decode_step_full_gang_p50_ms=1e3 * percentile(full_gang, 50),
         peak_memory_bytes=peak, cpu_prefill_logits_max_abs_err=cpu_err,
         cpu_tol=GEN_CPU_TOL, cpu_tokens=cpu_tokens, card_tokens=first,
         card=smi)
    if cpu_err > GEN_CPU_TOL:
        raise AssertionError(f"prefill logits differ from the CPU run by "
                             f"{cpu_err} (tol {GEN_CPU_TOL})")
    check_streams("card against CPU", layer, prompts[:1], {"g0": first},
                  {"g0": cpu_tokens})
    return launches[attn.KERNEL_NAME]


def generate_fast_path(layer, seed):
    """FAST_REQUESTS requests on the same weights through the plain
    engine, then chunked joins with a prefix cache (and two repeated
    prompts that must hit), int8 slabs and speculative decoding."""
    prompts = gen_prompts(seed + 8, FAST_REQUESTS)
    kw = dict(max_slots=GEN_SLOTS)
    ref, _, _ = run_scheduler(TransformerDecodeEngine(layer), prompts,
                              FAST_NEW_TOKENS, prefill_chunk=0, **kw)
    ref = {u: p["tokens"] for u, p in ref.items()}
    # chunked joins and the prefix cache
    cache = PrefixCache(max_bytes=1 << 31)
    eng = TransformerDecodeEngine(layer, prefix_cache=cache)
    chunked, _, _ = run_scheduler(eng, prompts, FAST_NEW_TOKENS,
                                  prefill_chunk=FAST_CHUNK, **kw)
    chunked = {u: p["tokens"] for u, p in chunked.items()}
    check_streams("chunked joins", layer, prompts, chunked, ref)
    chunk_calls = eng.prefill_calls
    repeat = [prompts[0], prompts[-1]]
    hits, _, _ = run_scheduler(eng, repeat, FAST_NEW_TOKENS,
                               prefill_chunk=FAST_CHUNK, **kw)
    if eng.prefill_calls != chunk_calls or cache.hits != 2:
        raise AssertionError(f"prefix-cache hits ran prefills: "
                             f"{eng.prefill_calls} != {chunk_calls}, "
                             f"{cache.stats()}")
    check_streams("prefix-cache hits", layer, repeat,
                  {u: p["tokens"] for u, p in hits.items()},
                  {"g0": chunked["g0"], "g1": chunked[f"g{len(prompts)-1}"]})
    # int8 slabs: (1 + 4/d)/4 of the f32 bytes
    eng8 = TransformerDecodeEngine(layer, kv_dtype="int8")
    int8, _, _ = run_scheduler(eng8, prompts, FAST_NEW_TOKENS, **kw)
    cap = GPT_CONFIG["seq_len"]
    bytes8 = kv_cache.kv_slab_bytes(eng8.alloc(GEN_SLOTS, cap))
    bytes32 = kv_cache.kv_slab_bytes(eng.alloc(GEN_SLOTS, cap))
    d = GPT_CONFIG["hidden_size"] // GPT_CONFIG["n_head"]
    if bytes8 * 4 * d != bytes32 * (d + 4):
        raise AssertionError(f"int8 slabs {bytes8} B vs f32 {bytes32} B")
    agree = np.mean([a == b for u in ref
                     for a, b in zip(int8[u]["tokens"], ref[u])])
    # speculative decoding with a draft of the target's first blocks
    spec = SpeculativeDecodeEngine(TransformerDecodeEngine(layer),
                                   TransformerDecodeEngine(draft_of(layer)),
                                   k=SPEC_K)
    spec_out, _, spec_wall = run_scheduler(spec, prompts, FAST_NEW_TOKENS,
                                           prefill_chunk=FAST_CHUNK, **kw)
    check_streams("speculative", layer, prompts,
                  {u: p["tokens"] for u, p in spec_out.items()}, ref)
    emit("generate", check="fast path", requests=FAST_REQUESTS,
         max_new_tokens=FAST_NEW_TOKENS, prefill_chunk=FAST_CHUNK,
         prompt_lengths=[int(p.size) for p in prompts],
         chunked_equal_plain=True, chunked_prefill_calls=chunk_calls,
         prefix_cache=cache.stats(), prefix_hits_equal_misses=True,
         int8_slab_bytes=bytes8, f32_slab_bytes=bytes32,
         int8_bytes_ratio=bytes8 / bytes32, int8_token_agreement=agree,
         speculative_equal_plain=True, speculative=spec.stats(),
         speculative_wall_s=spec_wall)


def check_chunk_on_card(layer, seed, device):
    """On a gang of GEN_SLOTS prompts prefilled at capacity 512:
    ``decode_chunk`` over 4 tokens against 4 ``decode_step`` calls, and
    the cached-decode probe of both. Returns the state and the fed
    tokens."""
    prompts = gen_prompts(seed + 9, GEN_SLOTS)
    cap = GPT_CONFIG["seq_len"]
    toks = np.zeros((GEN_SLOTS, max(p.size for p in prompts)), np.int64)
    for j, p in enumerate(prompts):
        toks[j, :p.size] = p
    lens = torch.tensor([p.size for p in prompts], dtype=torch.int32,
                        device=device)
    _, state = layer.prefill(torch.from_numpy(toks).to(device), lens,
                             layer.init_decode_state(GEN_SLOTS, cap))
    feed = torch.randint(1, GPT_CONFIG["vocab"], (GEN_SLOTS, 4),
                         generator=torch.Generator().manual_seed(seed))
    feed = feed.to(device)
    cached = {
        "decode_step": kv_cache.decode_step_is_cached(
            layer.decode_step, state.clone(), feed[:, 0], capacity=cap),
        "decode_chunk": kv_cache.decode_step_is_cached(
            layer.decode_chunk, state.clone(), feed, capacity=cap)}
    chunk_logits, _ = layer.decode_chunk(state.clone(), feed)
    st = state.clone()
    errs, same = [], True
    for c in range(feed.shape[1]):
        step_logits, st = layer.decode_step(st, feed[:, c])
        errs.append((step_logits - chunk_logits[:, c]).abs().max().item())
        same &= torch.equal(step_logits.argmax(-1),
                            chunk_logits[:, c].argmax(-1))
    emit("generate", check="on the card", gang=GEN_SLOTS, capacity=cap,
         chunk=feed.shape[1], chunk_vs_step_max_abs_err=max(errs),
         tol=CHUNK_STEP_TOL, greedy_equal=same, decode_step_is_cached=cached)
    if max(errs) > CHUNK_STEP_TOL or not same or not all(cached.values()):
        raise AssertionError(f"chunk vs step {errs}, greedy {same}, "
                             f"cached {cached}")
    return state, feed


def time_generation(layer, state, tok, seed, device, smi):
    """Prefill at PREFILL_SHAPES (host wall, device time by kernel group,
    K1 there) and one decode step on ``state`` (wall, host enqueue,
    device busy and idle share, its byte bound). Returns K1's timing at
    the last prefill shape."""
    cap = GPT_CONFIG["seq_len"]
    prefill = {}
    for b, l in PREFILL_SHAPES:
        ptoks = torch.randint(1, GPT_CONFIG["vocab"], (b, l),
                              generator=torch.Generator().manual_seed(l))
        ptoks = ptoks.to(device)
        plens = torch.full((b,), l, dtype=torch.int32, device=device)
        pstate = layer.init_decode_state(b, cap)
        fn = lambda: layer.prefill(ptoks, plens, pstate)
        walls = []
        for _ in range(6):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        prefill[f"B={b},L={l}"] = dict(
            wall_p50_ms=1e3 * percentile(walls[1:], 50),
            profile=profile_device(fn),
            k1=time_prefill_kernel(device, seed + l, b, l))
    enqueue, walls = [], []
    for _ in range(TIMED_DECODE_STEPS):
        t1 = time.perf_counter()
        _, state = layer.decode_step(state, tok)
        enqueue.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    weight_bytes = sum(int(p.nbytes) for p in layer.parameters())
    slab_bytes = kv_cache.kv_slab_bytes(state)
    step_bound, step_bound_by = bound_ms(
        weight_bytes + slab_bytes,
        2 * GEN_SLOTS * sum(p.numel() for p in layer.parameters()),
        CUDA_CORE_F32_FLOPS)
    emit("timing", path="generate", card=smi, prefill=prefill,
         decode_step=dict(
             gang=GEN_SLOTS, capacity=cap,
             lengths=state.lengths.tolist(),
             wall_p50_ms=1e3 * percentile(walls, 50),
             enqueue_p50_ms=1e3 * percentile(enqueue, 50),
             weight_bytes=weight_bytes, slab_bytes=slab_bytes,
             bound_ms=step_bound, bound_by=step_bound_by,
             profile=profile_device(lambda: layer.decode_step(state, tok))),
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"))
    b, l = PREFILL_SHAPES[-1]
    return prefill[f"B={b},L={l}"]["k1"]


def generate(seed, device, smi):
    """The generate phase on a GPT-width decoder from ``seed``: the main
    run, the fast path, the on-card checks and the timing. Returns K1's
    launches in the main run and its timing at the join prefill shape."""
    layer = build_decoder(seed + 5)
    launches = generate_main_run(layer, seed, device, smi)
    generate_fast_path(layer, seed)
    state, feed = check_chunk_on_card(layer, seed, device)
    return launches, time_generation(layer, state, feed[:, 0], seed,
                                     device, smi)


# ---------------------------------------------------------------------------
# checkpoint: the engine's store, failure policy, accumulation, save/load
# ---------------------------------------------------------------------------

# bench.py's classifier in bf16 on int32 ids (the train_bf16 setup) over 8
# distinct batches of TRAIN_BATCH rows, shuffled per epoch, 2 epochs; a
# checkpoint every CKPT_EVERY steps into a store keeping CKPT_KEEP.
# ``ckpt_model``'s depth (the checkpoint, observe and data phases' BERT):
# cut from bench.py's 12 blocks to 4, at full width, to keep the script
# inside its time limit beside the estimators phase
CKPT_BLOCKS = 4
CKPT_BATCHES, CKPT_EPOCHS, CKPT_EVERY, CKPT_KEEP = 8, 2, 4, 2
CKPT_STEPS = CKPT_BATCHES * CKPT_EPOCHS
CKPT_FAIL_AT, CKPT_PREEMPT_AT, CKPT_LOG_EVERY = 10, 6, 2
CKPT_ACCUM = 4
# the phase's directories, under the checkout (build/ is ignored by git),
# deleted when the phase ends
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_checkpoint")
# alternating windows of one epoch each: an async checkpoint every
# CKPT_EVERY steps against none
CKPT_TIMED_WINDOWS = 2
CKPT_SERVE_ROWS, CKPT_RESNET_ROWS = 8, 8
# one step, dropout off, accumulation CKPT_ACCUM against 1 on the same
# weights and batch: the loss, and each parameter's gradient relative to
# its norm, at the train parity gate's tolerances (PERF.md §2). Float32:
# products summed over 8-row microbatches and then added, against one sum
# over 32 rows; the head's 2-element bias gradient, a sum of 32 terms that
# mostly cancel, moves 8e-5 of its norm under that alone. bf16: the
# products' bf16 roundings fall at other places.
ACCUM_LOSS_TOL = {"float32": TRAIN_LOSS_TOL, "bfloat16": BF16_LOSS_TOL}
ACCUM_GRAD_TOL = {"float32": TRAIN_GRAD_TOL, "bfloat16": BF16_GRAD_TOL}
# bf16: a gradient past ACCUM_GRAD_TOL of its norm passes when accumulation
# lands no further than this many times the full batch's distance from
# the float32 step's gradient (see check_accumulation): accumulation
# rounds CKPT_ACCUM partial sums to bf16 where the full batch rounds one,
# so its rounding error is up to CKPT_ACCUM times the full batch's
# (about sqrt(CKPT_ACCUM) times when the roundings are independent)
ACCUM_BF16_FACTOR = float(CKPT_ACCUM)


class _Config:
    """Set fields of the context's config for a ``with`` block."""

    def __init__(self, **fields):
        self.fields = fields

    def __enter__(self):
        cfg = init_nncontext().config
        self.saved = {k: getattr(cfg, k) for k in self.fields}
        for k, v in self.fields.items():
            setattr(cfg, k, v)

    def __exit__(self, *exc):
        cfg = init_nncontext().config
        for k, v in self.saved.items():
            setattr(cfg, k, v)
        return False


class _Tap(ZooTrigger):
    """A checkpoint trigger wrapping ``inner`` that also calls ``fn`` the
    first time iteration ``at`` is reached, mid-epoch (``fn`` may record
    the state, or request a preemption)."""

    def __init__(self, inner, at=None, fn=None):
        self.inner, self.at, self.fn = inner, at, fn

    def __call__(self, record):
        if self.fn is not None and record.iteration == self.at and \
                not record.epoch_finished:
            self.fn()
            self.fn = None
        return self.inner(record)


class _StepClock(ZooTrigger):
    """A checkpoint trigger wrapping ``inner`` (or none) that synchronises
    the card and reads the host clock after every step."""

    def __init__(self, inner=None):
        self.inner, self.ticks = inner, []

    def __call__(self, record):
        if not record.epoch_finished:
            torch.cuda.synchronize()
            self.ticks.append(time.perf_counter())
        return self.inner(record) if self.inner is not None else False


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def ckpt_model(seed, dropout=TRAIN_P_DROP, dtype="bfloat16"):
    """The classifier of ``build_classifier``, CKPT_BLOCKS deep, with named
    layers: every run of the phase writes the same layer names into its
    checkpoints, so two runs' files can be compared byte for byte."""
    config = dict(BERT_CONFIG, n_block=CKPT_BLOCKS, hidden_p_drop=dropout,
                  attn_p_drop=dropout)
    l = config["seq_len"]
    ins = [L.Input(shape=(l,), name=n) for n in
           ("tokens", "positions", "segments")] + \
        [L.Input(shape=(1, 1, l), name="mask")]
    _, pooled = L.BERT(name="ckpt_bert", **config)(ins)
    model = Model(ins, L.Dense(N_CLASSES, activation="softmax",
                               name="ckpt_head")(pooled), seed=seed)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.set_compute_dtype(dtype)
    return model


def trainer_state(trainer):
    """(name, device clone) of every parameter and Adam moment."""
    moments = trainer.opt_state[0]
    out = [(k, p.detach().clone()) for k, p in trainer.params().items()]
    out += [(f"{part}:{k}", t.detach().clone())
            for part in ("mu", "nu") for k, t in moments[part].items()]
    return out


def check_state_equal(trainer, want, what):
    """Every tensor of ``trainer_state`` equal to ``want``'s, in order (a
    model built anew has other auto-generated layer names)."""
    got = trainer_state(trainer)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tensors, expected "
                             f"{len(want)}")
    bad = [k for (k, g), (_, t) in zip(got, want) if not torch.equal(g, t)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ from the "
                             f"reference run, first {bad[0]}")


def manifest_crcs(directory):
    out = {}
    for sub in sorted(os.listdir(directory)):
        if sub.startswith(SPMDTrainer.CKPT_PREFIX):
            with open(os.path.join(directory, sub, "manifest.json")) as f:
                out[sub] = {k: v["crc32c"] for k, v in
                            json.load(f)["files"].items()}
    return out


def ckpt_fit(model, x, y, directory, trigger, epochs=CKPT_EPOCHS, **kw):
    model.set_checkpoint(directory, trigger=trigger)
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=epochs, **kw)
    return model.trainer


def collect():
    """Free the card's memory of the models dropped so far (their graphs
    hold reference cycles)."""
    gc.collect()
    torch.cuda.empty_cache()


def _rel(a, b):
    return ((a - b).norm() / max(b.norm().item(), 1e-12)).item()


def check_accumulation(seed, device):
    """One dropout-off step with accumulation CKPT_ACCUM against the same
    step without, on one batch and the same weights: float32, then bf16.
    The loss within ACCUM_LOSS_TOL; each gradient within ACCUM_GRAD_TOL of
    its norm, or in bf16, where a small gradient summed from terms that
    cancel (the head's 2-element bias) carries bf16's rounding of each
    microbatch's partial sum, no further from the float32 step's gradient
    than ACCUM_BF16_FACTOR times the bf16 full batch's own distance."""
    out = {}
    loss_fn = get_loss("sparse_categorical_crossentropy")
    ref = None
    for dtype in ("float32", "bfloat16"):
        model = build_classifier(seed + 7, dict(
            BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0))
        trainer = SPMDTrainer(model, loss_fn, Adam(lr=TRAIN_LR),
                              device=device, compute_dtype=dtype)
        trainer.ensure_initialized()
        x, y, _ = train_data(seed + 7, TRAIN_BATCH, ids=np.int32
                             if dtype == "bfloat16" else np.float32)
        batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
        runs = {}
        for accum in (1, CKPT_ACCUM):
            with _Config(grad_accum_steps=accum):
                loss = trainer.loss_and_grads(batch).item()
            runs[accum] = (loss, [p.grad.detach().clone() for p in
                                  model.parameters()])
        names = [k for k, _ in model.named_parameters()]
        (l1, g1), (l4, g4) = runs[1], runs[CKPT_ACCUM]
        tol = ACCUM_GRAD_TOL[dtype]
        worst, worst_name, bad = 0.0, None, []
        for k, a, b, r in zip(names, g4, g1, ref or [None] * len(names)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{k}: non-finite accumulated gradient")
            rel = _rel(a, b)
            if rel > worst:
                worst, worst_name = rel, k
            if rel > tol and (r is None or _rel(a, r) >
                              ACCUM_BF16_FACTOR * _rel(b, r)):
                bad.append(k)
        res = dict(loss_accum1=l1, loss_accum4=l4, loss_err=abs(l4 - l1),
                   loss_tol=ACCUM_LOSS_TOL[dtype], max_grad_rel_err=worst,
                   max_grad_rel_err_param=worst_name, grad_tol=tol)
        if ref is not None:
            k = names.index(worst_name)
            res.update(worst_accum4_vs_float32=_rel(g4[k], ref[k]),
                       worst_accum1_vs_float32=_rel(g1[k], ref[k]),
                       float32_factor=ACCUM_BF16_FACTOR)
        out[dtype] = res
        if res["loss_err"] > res["loss_tol"] or bad:
            emit("checkpoint", ok=False, accumulation=out)
            raise AssertionError(f"accumulation {CKPT_ACCUM} differs from "
                                 f"the full batch in {dtype} ({bad}): {res}")
        if ref is None:
            ref = g1
        del model, trainer, runs, g4
        collect()
    return out


def time_accumulation(model, x, y):
    """Launches of one training step under accumulation CKPT_ACCUM, then
    the step at accumulation 1 and CKPT_ACCUM in alternating windows of
    TIMED_STEPS steps (1, 4, 4, 1): wall per step and peak memory."""
    trainer = model.trainer
    batch = trainer.put_batch(([a[:TRAIN_BATCH] for a in x], y[:TRAIN_BATCH],
                               np.ones(TRAIN_BATCH, np.float32)))
    n_block = CKPT_BLOCKS
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    want = {k: CKPT_ACCUM * v for k, v in per_step.items()}
    with _Config(grad_accum_steps=CKPT_ACCUM):
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES.snapshot()
        dtypes = _kernels.LAUNCHES.by_dtype()
    if launches != want or any(set(v) != {"bfloat16"}
                               for v in dtypes.values()):
        raise AssertionError(f"accumulation {CKPT_ACCUM}: launches "
                             f"{dtypes}, expected {want} in bfloat16")
    step_s = {1: [], CKPT_ACCUM: []}
    peaks = {1: [], CKPT_ACCUM: []}
    for accum in (1, CKPT_ACCUM, CKPT_ACCUM, 1):
        with _Config(grad_accum_steps=accum):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                step_s[accum].append(time.perf_counter() - t0)
            peaks[accum].append(torch.cuda.max_memory_allocated())
    timing = {f"accum{a}": dict(step_ms=[1e3 * t for t in ts],
                                step_p50_ms=1e3 * percentile(ts, 50),
                                peak_memory_bytes=max(peaks[a]))
              for a, ts in step_s.items()}
    return launches, per_step, timing


def save_serve(model, x, directory, device):
    """``save_model``, ``InferenceModel().load`` and 8 rows served on the
    card, bit for bit against ``predict`` in float32 on the card."""
    model.set_compute_dtype("float32")
    rows = [a[:CKPT_SERVE_ROWS] for a in x]
    want = model.predict(rows, batch_size=CKPT_SERVE_ROWS)
    t0 = time.perf_counter()
    model.save_model(directory)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    im = InferenceModel().load(directory)
    load_s = time.perf_counter() - t0
    if im.model.device != device:
        raise AssertionError(f"InferenceModel.load put it on "
                             f"{im.model.device}")
    _kernels.LAUNCHES.reset()
    got = im.predict(rows)
    served_k1 = _kernels.LAUNCHES.get(attn.KERNEL_NAME)
    if not np.array_equal(got, want):
        raise AssertionError(f"the loaded classifier serves other outputs: "
                             f"max {np.abs(got - want).max()}")
    return dict(rows=CKPT_SERVE_ROWS, save_s=save_s, load_s=load_s,
                launches_served=served_k1, equal=True)


def save_serve_resnet(seed, directory):
    """A ResNet-50 ``ImageClassifier`` with seeded moving statistics
    through ``ZooModel.save_model`` and ``InferenceModel().load`` on the
    zoo-model directory: ``predict`` at batch 8, bit for bit."""
    clf = build_resnet(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in clf.model.named_buffers():
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen)
                      if name.endswith("moving_var") else
                      0.1 * torch.randn(buf.shape, generator=gen))
    x = np.random.default_rng(seed).standard_normal(
        (CKPT_RESNET_ROWS,) + RESNET_SHAPE).astype(np.float32)
    want = clf.predict(x, batch_size=CKPT_RESNET_ROWS)
    clf.save_model(directory)
    im = InferenceModel().load(directory)
    got = im.predict(x)
    if not np.array_equal(got, want):
        raise AssertionError(f"the loaded ResNet-50 serves other outputs: "
                             f"max {np.abs(got - want).max()}")
    n_stats = sum(1 for _ in clf.model.buffers())
    return dict(rows=CKPT_RESNET_ROWS, moving_statistics=n_stats,
                equal=True)


def time_async_steps(model, x, y, directory):
    """Steps with an async checkpoint every CKPT_EVERY steps against none,
    in alternating one-epoch windows (async, none, none, async, the first
    CKPT_TIMED_WINDOWS of them): each step's wall between synchronised
    clock reads, and the p50."""
    step_s = {"async": [], "none": []}
    with _Config(async_checkpoint=True, keep_checkpoints=CKPT_KEEP):
        for w in range(CKPT_TIMED_WINDOWS):
            kind = ("async", "none", "none", "async")[w % 4]
            clock = _StepClock(SeveralIteration(CKPT_EVERY)
                               if kind == "async" else None)
            ckpt_fit(model, x, y, directory, clock, epochs=1)
            step_s[kind] += list(np.diff(clock.ticks))
    model.trainer.wait_for_checkpoint()
    return {k: dict(step_ms=[1e3 * t for t in v],
                    step_p50_ms=1e3 * percentile(v, 50),
                    step_max_ms=1e3 * max(v))
            for k, v in step_s.items()}


def checkpoint(seed, device, smi, root):
    """The checkpoint phase (see the module docstring): returns the
    phase's report and the launches a step under accumulation."""
    os.makedirs(root, exist_ok=True)
    disk = shutil.disk_usage(root)
    dirs = {k: os.path.join(root, k) for k in
            ("reference", "retry", "preempt", "async", "timed", "tb",
             "saved_bert", "saved_resnet")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    x, y, _ = train_data(seed + 3, CKPT_BATCHES * TRAIN_BATCH, ids=np.int32)
    # labels apart from the tokens (train_data's first token carries its
    # label, which the classifier learns to a loss of 0.0 in 5 steps): the
    # losses stay informative over all 16 steps
    y = np.random.default_rng(seed + 5).integers(
        0, N_CLASSES, len(y)).astype(np.float32)
    val_x, val_y, _ = train_data(seed + 4, TRAIN_BATCH, ids=np.int32)
    messages = _Messages()
    logging.getLogger("analytics_zoo_tpu_torch.engine").addHandler(messages)
    logging.getLogger("analytics_zoo_tpu_torch.engine").setLevel(logging.INFO)
    report = dict(model="BERT-base classifier (bench.py:353-438)",
                  compute_dtype="bfloat16", ids="int32", batch=TRAIN_BATCH,
                  batches_per_epoch=CKPT_BATCHES, epochs=CKPT_EPOCHS,
                  checkpoint_every=CKPT_EVERY, keep=CKPT_KEEP,
                  free_disk_bytes_before=disk.free, card=smi)
    base = dict(keep_checkpoints=CKPT_KEEP, async_checkpoint=False,
                failure_retry_times=0, auto_resume=False,
                log_every_n_steps=CKPT_LOG_EVERY)

    # 1. the reference run R, with summaries and validation
    at12 = {}
    with _Config(**base):
        np.random.seed(seed)
        r_model = ckpt_model(seed + 11)
        r_model.set_tensorboard(dirs["tb"], "reference")
        trigger = _Tap(SeveralIteration(CKPT_EVERY), 3 * CKPT_EVERY,
                       lambda: at12.update(state=trainer_state(
                           r_model.trainer)))
        t0 = time.perf_counter()
        r = ckpt_fit(r_model, x, y, dirs["reference"], trigger,
                     validation_data=(val_x, val_y))
        r_wall = time.perf_counter() - t0
    r_losses = list(r.step_losses)
    ref = trainer_state(r)
    if r.step != CKPT_STEPS or len(r_losses) != CKPT_STEPS or \
            not np.isfinite(r_losses).all():
        raise AssertionError(f"reference run: step {r.step}, losses "
                             f"{r_losses}")
    r_crcs = manifest_crcs(dirs["reference"])
    if sorted(r_crcs) != [f"ckpt-{CKPT_STEPS - CKPT_EVERY}",
                          f"ckpt-{CKPT_STEPS}"]:
        raise AssertionError(f"retention kept {sorted(r_crcs)}")
    summary = r_model.get_train_summary("Loss")
    want_steps = list(range(CKPT_LOG_EVERY, CKPT_STEPS + 1, CKPT_LOG_EVERY))
    if [s for s, _, _, _ in summary] != want_steps or any(
            v != np.float32(r_losses[s - 1]) for s, _, _, v in summary):
        raise AssertionError(f"Loss summary {summary} against the step "
                             f"losses {r_losses}")
    val_summary = r_model.get_validation_summary()
    if not val_summary:
        raise AssertionError("no validation summary")
    saves = [s for s in r.checkpoint_stats]
    report["reference"] = dict(
        losses=r_losses, wall_s=r_wall, saves=len(saves),
        summary_loss_windows=len(summary),
        summary_tags=sorted({t for _, _, t, _ in
                             r_model.get_train_summary()}),
        validation_scalars=len(val_summary))
    report["sync_save"] = dict(
        bytes=saves[-1]["bytes"],
        per_save=[{k: v for k, v in s.items()} for s in saves])
    del r_model, r
    collect()

    # 2. a failed step at CKPT_FAIL_AT, retried in the same fit
    os.environ["ZOO_TPU_FAULT"] = f"step:raise@{CKPT_FAIL_AT}"
    faults.reset()
    try:
        with _Config(**dict(base, failure_retry_times=1)):
            np.random.seed(seed)
            f_model = ckpt_model(seed + 11)
            f = ckpt_fit(f_model, x, y, dirs["retry"],
                         SeveralIteration(CKPT_EVERY))
    finally:
        del os.environ["ZOO_TPU_FAULT"]
        faults.reset()
    check_state_equal(f, ref, "the retried run")
    retried = [m for m in messages.lines if m.startswith("step failed")]
    if (f.step, f.epoch) != (CKPT_STEPS, CKPT_EPOCHS) or not retried or \
            f.step_losses != r_losses:
        raise AssertionError(f"retried run: step {f.step} epoch {f.epoch} "
                             f"losses {f.step_losses}, log {retried}")
    restored = [m for m in messages.lines if m.startswith("restored")]
    report["retry"] = dict(fault=f"step:raise@{CKPT_FAIL_AT}",
                           log=retried + restored, equal=True)
    del f_model, f
    collect()
    shutil.rmtree(dirs["retry"])

    # 3. preemption at CKPT_PREEMPT_AT, then a fresh model resumes
    with _Config(**base):
        np.random.seed(seed)
        p_model = ckpt_model(seed + 11)
        try:
            ckpt_fit(p_model, x, y, dirs["preempt"],
                     _Tap(SeveralIteration(CKPT_EVERY), CKPT_PREEMPT_AT,
                          request_preemption))
            raise AssertionError("the preemption was not honoured")
        except TrainingPreempted:
            pass
        finally:
            clear_preemption()
        drained = p_model.trainer.step
    del p_model
    collect()
    with open(os.path.join(dirs["preempt"], "latest")) as fh:
        latest = fh.read()
    if drained != CKPT_PREEMPT_AT or latest != f"ckpt-{CKPT_PREEMPT_AT}":
        raise AssertionError(f"drained at {drained}, latest {latest}")
    messages.lines.clear()
    with _Config(**dict(base, auto_resume=True)):
        a_model = ckpt_model(seed + 23)     # other weights: the load must win
        a = ckpt_fit(a_model, x, y, dirs["preempt"],
                     SeveralIteration(CKPT_EVERY))
    resumed = [m for m in messages.lines if m.startswith("auto-resume")]
    want_log = f"auto-resume: restored step {CKPT_PREEMPT_AT} epoch 0 " \
        f"(+{CKPT_PREEMPT_AT} batches)"
    if not resumed or not resumed[0].startswith(want_log):
        raise AssertionError(f"auto-resume said {resumed}")
    check_state_equal(a, ref, "the resumed run")
    if a.step != CKPT_STEPS or a.step_losses != r_losses[CKPT_PREEMPT_AT:]:
        raise AssertionError(f"resumed run: step {a.step} losses "
                             f"{a.step_losses}")
    report["preempt"] = dict(drained_at=drained, resumed=resumed[0],
                             load_s=a.last_load_s, equal=True)
    del a_model, a
    collect()
    shutil.rmtree(dirs["preempt"])

    # 4. async writes: the same state and the same bytes as R
    with _Config(**dict(base, async_checkpoint=True)):
        np.random.seed(seed)
        s_model = ckpt_model(seed + 11)
        s = ckpt_fit(s_model, x, y, dirs["async"],
                     SeveralIteration(CKPT_EVERY))
    check_state_equal(s, ref, "the async run")
    if s.step_losses != r_losses:
        raise AssertionError(f"async run losses {s.step_losses}")
    s_crcs = manifest_crcs(dirs["async"])
    if s_crcs != r_crcs:
        raise AssertionError(f"async checkpoints {s_crcs} against the "
                             f"reference's {r_crcs}")
    report["async"] = dict(
        equal=True, same_crc32c=sorted(s_crcs),
        stall_ms=[1e3 * st["stall_s"] for st in s.checkpoint_stats],
        snapshot_ms=[1e3 * st["snapshot_s"] for st in s.checkpoint_stats],
        wait_for_previous_ms=[1e3 * st["wait_s"]
                              for st in s.checkpoint_stats])
    shutil.rmtree(dirs["async"])

    # 5. gradient accumulation: launches, time and memory on the trained
    # model, then the dropout-off step against accumulation 1
    launches, per_step, acc_timing = time_accumulation(s_model, x, y)
    report["accumulation"] = dict(
        steps=CKPT_ACCUM, launches_per_step=launches,
        launches_per_step_accum1=per_step, timing=acc_timing)
    # the step with and without an async checkpoint every CKPT_EVERY
    report["async_step_timing"] = time_async_steps(s_model, x, y,
                                                   dirs["timed"])
    shutil.rmtree(dirs["timed"], ignore_errors=True)

    # 6. a corrupt newest checkpoint falls back to the previous one
    newest = f"ckpt-{CKPT_STEPS}"
    path = os.path.join(dirs["reference"], newest, "optim.npz")
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))
    messages.lines.clear()
    s.load_checkpoint(dirs["reference"])
    skipped = [m for m in messages.lines if "unusable" in m]
    if s.step != CKPT_STEPS - CKPT_EVERY or not skipped:
        raise AssertionError(f"after the corruption: step {s.step}, "
                             f"log {messages.lines}")
    check_state_equal(s, at12["state"], "the fallback restore")
    report["corruption"] = dict(flipped=f"{newest}/optim.npz",
                                restored_step=s.step, log=skipped[0],
                                load_s=s.last_load_s, equal=True)
    with open(os.path.join(dirs["reference"], f"ckpt-{CKPT_STEPS - CKPT_EVERY}",
                           "model.npz"), "rb") as fh:
        blob = fh.read()
    t0 = time.perf_counter()
    crc32c(blob)
    crc_s = time.perf_counter() - t0
    report["crc32c"] = dict(bytes=len(blob), s=crc_s,
                            gb_per_s=len(blob) / crc_s / 1e9)
    del at12, ref, blob
    shutil.rmtree(dirs["reference"])

    # 7. save, load, serve
    report["save_serve_bert"] = save_serve(s_model, x, dirs["saved_bert"],
                                           device)
    del s_model, s
    collect()
    report["accumulation"]["parity"] = check_accumulation(seed, device)
    report["save_serve_resnet"] = save_serve_resnet(seed + 13,
                                                    dirs["saved_resnet"])
    logging.getLogger("analytics_zoo_tpu_torch.engine").removeHandler(
        messages)
    shutil.rmtree(root)
    collect()
    return report, launches


# ---------------------------------------------------------------------------
# the sequence models: recurrent layers, TextClassifier and the zoo
# ---------------------------------------------------------------------------

# the reference TextClassifier example's defaults (pyzoo/zoo/examples/
# textclassification/text_classification.py, news20): 20 classes, 500
# tokens a text, GloVe 6B 200-d vectors for the 5000 most frequent words
# (a seeded (5001, 200) table stands in: no GloVe file is in the
# repository), encoder output 256, batch 128, Adagrad at 0.01
TC_CLASSES, TC_SEQ_LEN, TC_TOKEN_LEN, TC_MAX_WORDS = 20, 500, 200, 5000
TC_ENCODER_DIM, TC_BATCH, TC_STEPS, TC_LR = 256, 128, 8, 0.01
TC_ENCODERS = ("cnn", "lstm", "gru")
TC_PREDICT_ROWS = 32
TC_TIMED_STEPS, TC_WINDOWS = 5, 2
# the card's predictions against the port's CPU run of the same weights:
# a 500-step recurrence (and the convolution) in float32, summed in
# another order by cuBLAS / cuDNN and the CPU's BLAS
SEQ_CPU_TOL = 1e-4
# the other zoo models: predict against the CPU, then SEQ_FIT_STEPS steps
# of fit on one seeded batch
SEQ_FIT_STEPS = 4
# AnomalyDetector at the repo example's unroll (24) and the model's
# default hidden widths and dropouts
AD_UNROLL, AD_HIDDEN, AD_DROPOUTS, AD_BATCH = 24, (8, 32, 15), \
    (0.2, 0.2, 0.2), 1024
# KNRM at the reference's defaults (KNRM.scala): query 10, document 40,
# 300-d embeddings, 21 kernels; a 20,000-word vocabulary
KNRM_L1, KNRM_L2, KNRM_VOCAB, KNRM_EMBED, KNRM_KERNELS = 10, 40, 20000, \
    300, 21
KNRM_PAIRS, KNRM_QUERIES, KNRM_CANDIDATES = 256, 32, 10
# the ranking leg's corpora, as TextSets: KNRM_QUERIES queries of KNRM_L1
# words, each with KNRM_RELEVANT documents of KNRM_L2 words that open
# with the query's words and KNRM_IRRELEVANT random ones, over the
# 26**3 three-letter words (a vocabulary below KNRM_VOCAB); one relation
# pair a relevant document gives 256 pairs
KNRM_WORDS, KNRM_RELEVANT, KNRM_IRRELEVANT = 26 ** 3, 8, 8
# SessionRecommender at its default rnn and mlp widths (40, 20), with the
# history: 10,000 items embedded in 100, sessions of 10 clicks and
# histories of 5 (chosen here: the reference sets no defaults)
SR_ITEMS, SR_EMBED, SR_SESSION, SR_HISTORY, SR_BATCH = 10000, 100, 10, 5, \
    1024
SR_RECOMMEND, SR_MAX_ITEMS = 16, 5
# Seq2seq: an LSTM of 2 layers and 256 wide, a dense bridge, a
# TimeDistributed(Dense(feat)) generator
S2S_LAYERS, S2S_HIDDEN, S2S_FEAT, S2S_T_IN, S2S_T_OUT, S2S_BATCH = \
    2, 256, 32, 40, 20, 64
S2S_INFER_ROWS, S2S_INFER_LEN = 8, 20
# infer_reference re-runs the decoder over the whole prefix, so its
# products differ in shape (and summation) from the cached step's
S2S_REFERENCE_TOL = 1e-4


def cpu_twin(model):
    """A copy of ``model`` (a KerasNet on the card) on the CPU, with a CPU
    trainer."""
    trainer, model.trainer = model.trainer, None
    try:
        cpu_model = copy.deepcopy(model)
    finally:
        model.trainer = trainer
    cpu_model.trainer = SPMDTrainer(cpu_model, get_loss("mse"),
                                    get_optimizer("sgd"), device="cpu")
    return cpu_model


def zoo_twin(model):
    """A zoo model over the CPU twin of ``model``'s Keras model."""
    twin = copy.copy(model)
    twin.model = cpu_twin(model.model)
    return twin


def seeded_zoo_model(make, seed):
    """A zoo model built with the context's seed set to ``seed`` (its
    weights come from the seed the graph is built under)."""
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    try:
        model = make()
        model.model.graph_function()
    finally:
        config.seed = seed0
    return model


def keras_of(model):
    """The Keras model of a zoo model, or ``model`` itself."""
    return model if hasattr(model, "graph_function") else model.model


def check_predict(name, model, x, batch):
    """``predict`` on the card against the CPU's: the largest
    difference, gated at SEQ_CPU_TOL."""
    got = model.predict(x, batch_size=batch)
    want = cpu_twin(keras_of(model)).trainer.predict(x, batch_size=batch)
    got_l = got if isinstance(got, list) else [got]
    want_l = want if isinstance(want, list) else [want]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got_l, want_l))
    if not all(np.isfinite(g).all() and g.shape == w.shape
               for g, w in zip(got_l, want_l)) or err > SEQ_CPU_TOL:
        raise AssertionError(f"{name}: predict on the card off the CPU's "
                             f"by {err} (tol {SEQ_CPU_TOL})")
    return got, err


def no_launches(name):
    """K1-K5's launches since the sequence phase set the counts to 0:
    none, or ``name`` fails."""
    launches = _kernels.LAUNCHES.snapshot()
    if launches:
        raise AssertionError(f"{name} launched hand-written kernels "
                             f"{launches}")
    return launches


def fit_one_batch(name, model, x, y, batch, steps):
    """``steps`` steps of ``fit`` on one batch (one epoch a step): the
    losses (finite and falling), K1-K5's launches since the phase began
    (none), the wall and the peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=batch, nb_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = no_launches(name)
    peak = torch.cuda.max_memory_allocated()
    losses = list(keras_of(model).trainer.step_losses)
    if len(losses) != steps or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{name} losses {losses}")
    return dict(losses=losses, k1_k5_launches=launches, fit_wall_s=wall,
                peak_memory_bytes=peak)


def text_data(seed, n):
    rs = np.random.default_rng(seed)
    x = rs.integers(0, TC_MAX_WORDS + 1, (n, TC_SEQ_LEN)).astype(np.int32)
    y = rs.integers(0, TC_CLASSES, n).astype(np.int32)
    return x, y


def text_classifier_leg(encoder, seed, table, x, y):
    """The full-width TextClassifier with ``encoder``: predict against
    the CPU; TC_STEPS steps of fit (falling loss, a finite nonzero
    gradient on every trainable parameter, the frozen table unmoved,
    K1-K5 not launched); evaluate."""
    model = seeded_zoo_model(lambda: TextClassifier(
        TC_CLASSES, table, sequence_length=TC_SEQ_LEN, encoder=encoder,
        encoder_output_dim=TC_ENCODER_DIM), seed)
    probs, err = check_predict(f"TextClassifier({encoder})", model,
                               x[:TC_PREDICT_ROWS], TC_PREDICT_ROWS)
    no_launches(f"TextClassifier({encoder}) predict")
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if row_err > ROW_SUM_TOL:
        raise AssertionError(f"TextClassifier({encoder}) predict rows off "
                             f"1 by {row_err}")
    table_layer = model.model.layers[0]
    table0 = table_layer.table.detach().clone()
    model.compile(Adagrad(lr=TC_LR), "sparse_categorical_crossentropy",
                  ["accuracy"])
    fit = fit_one_batch(f"TextClassifier({encoder})", model, x, y,
                        TC_BATCH, TC_STEPS)
    grads = {}
    for n, p in model.model.named_parameters():
        if p is table_layer.table:
            continue
        g = p.grad
        grads[n] = 0.0 if g is None or not torch.isfinite(g).all() \
            else g.abs().max().item()
    if min(grads.values()) <= 0.0:
        raise AssertionError(f"TextClassifier({encoder}) parameters "
                             f"without a gradient: "
                             f"{[n for n, g in grads.items() if g <= 0]}")
    if not torch.equal(table_layer.table.detach(), table0) or (
            table_layer.table.grad is not None and
            table_layer.table.grad.any()):
        raise AssertionError(f"TextClassifier({encoder}): the frozen "
                             "table moved or took a gradient")
    results = model.evaluate(x, y, batch_size=TC_BATCH)
    if not np.isfinite(results["loss"]) or \
            not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"TextClassifier({encoder}) evaluate "
                             f"{results}")
    return model, dict(
        encoder=encoder, params=sum(p.numel() for p in
                                    model.model.parameters()),
        predict_rows=TC_PREDICT_ROWS, predict_cpu_max_abs_err=err,
        predict_row_sum_max_err=row_err, min_param_grad=min(grads.values()),
        trainable_params_with_grad=len(grads), frozen_table_unmoved=True,
        evaluate=results, **fit)


def time_text_classifiers(models, x, y):
    """Each encoder's training step in alternating windows of
    TC_TIMED_STEPS (cnn, lstm, gru, gru, lstm, cnn): host clock around a
    synchronised step, p50, each window's peak memory; then one step's
    device time, launches and idle share from the profiler."""
    host = ([x], y, np.ones(len(y), np.float32))
    trainers = {e: m.model.trainer for e, m in models.items()}
    batches = {e: t.put_batch(host) for e, t in trainers.items()}
    step_s = {e: [] for e in models}
    peaks = {e: [] for e in models}
    order = list(models)
    for w in range(TC_WINDOWS):
        for e in (order if w % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TC_TIMED_STEPS):
                t0 = time.perf_counter()
                trainers[e].train_step(batches[e])
                torch.cuda.synchronize()
                step_s[e].append(time.perf_counter() - t0)
            peaks[e].append(torch.cuda.max_memory_allocated())
    out = {}
    for e in models:
        prof = profile_device(lambda: trainers[e].train_step(batches[e]))
        launches = sum(g["launches"] for g in (prof["groups"] or {})
                       .values())
        out[e] = dict(step_ms=[1e3 * t for t in step_s[e]],
                      step_p50_ms=1e3 * percentile(step_s[e], 50),
                      texts_per_s=TC_BATCH / percentile(step_s[e], 50),
                      peak_memory_bytes=max(peaks[e]),
                      launches_per_step=launches,
                      device_busy_ms=prof.get("device_busy_ms"),
                      idle_share=prof["idle_share"], profile=prof)
    return dict(windows=TC_WINDOWS, steps_per_window=TC_TIMED_STEPS,
                batch=TC_BATCH, **out)


def anomaly_leg(seed):
    rs = np.random.default_rng(seed)
    t = np.arange(AD_BATCH + AD_UNROLL, dtype=np.float32)
    series = np.sin(t / 12.0) + 0.1 * rs.standard_normal(t.shape)
    feats, labels, _ = AnomalyDetector.unroll(series, AD_UNROLL)
    feats, labels = feats[:AD_BATCH], labels[:AD_BATCH, None]
    model = seeded_zoo_model(lambda: AnomalyDetector(
        (AD_UNROLL, 1), hidden_layers=AD_HIDDEN, dropouts=AD_DROPOUTS), seed)
    _, err = check_predict("AnomalyDetector", model, feats, AD_BATCH)
    model.compile("rmsprop", "mse")
    fit = fit_one_batch("AnomalyDetector", model, feats, labels, AD_BATCH,
                        SEQ_FIT_STEPS)
    pred = model.predict(feats, batch_size=AD_BATCH).reshape(-1)
    _, _, anomaly = AnomalyDetector.detect_anomalies(labels, pred, 5)
    flagged = int(np.isfinite(anomaly).sum())
    if flagged < 1:
        raise AssertionError("AnomalyDetector flagged nothing")
    return dict(feature_shape=[AD_UNROLL, 1], hidden_layers=AD_HIDDEN,
                dropouts=AD_DROPOUTS, batch=AD_BATCH, optimizer="rmsprop",
                loss="mse", predict_cpu_max_abs_err=err,
                anomalies_flagged=flagged, **fit)


def knrm_pairs(rs, n):
    """n interleaved (relevant, irrelevant) documents for n / 2 queries:
    the relevant one repeats the query's words."""
    q = rs.integers(1, KNRM_VOCAB, (n // 2, KNRM_L1))
    pos = np.tile(q, (1, KNRM_L2 // KNRM_L1 + 1))[:, :KNRM_L2]
    neg = rs.integers(1, KNRM_VOCAB, (n // 2, KNRM_L2))
    x = np.empty((n, KNRM_L1 + KNRM_L2), np.float32)
    x[0::2] = np.concatenate([q, pos], 1)
    x[1::2] = np.concatenate([q, neg], 1)
    y = np.zeros((n, 1), np.float32)
    y[0::2] = 1.0
    return x, y


def knrm_group(rs):
    """One query's KNRM_CANDIDATES documents: the first two repeat the
    query's words (label 1), the rest are random (label 0)."""
    q = rs.integers(1, KNRM_VOCAB, KNRM_L1)
    docs = rs.integers(1, KNRM_VOCAB, (KNRM_CANDIDATES, KNRM_L2))
    docs[:2, :KNRM_L1] = q
    x = np.concatenate([np.tile(q, (KNRM_CANDIDATES, 1)), docs], 1)
    labels = np.zeros(KNRM_CANDIDATES, np.float32)
    labels[:2] = 1.0
    return x.astype(np.float32), labels


def knrm_word(i):
    return chr(97 + i // 676 % 26) + chr(97 + i // 26 % 26) + chr(97 + i % 26)


def knrm_corpora(rs):
    """The ranking leg's query and document TextSets, through tokenize,
    normalize, word2idx (the documents extend the queries' index) and
    shape_sequence, and their relations."""
    queries, docs, relations = [], [], []
    for qi in range(KNRM_QUERIES):
        words = [knrm_word(int(i))
                 for i in rs.integers(0, KNRM_WORDS, KNRM_L1)]
        queries.append(TextFeature(" ".join(words).title() + ".",
                                   uri=f"q{qi}"))
        for j in range(KNRM_RELEVANT + KNRM_IRRELEVANT):
            body = [knrm_word(int(i))
                    for i in rs.integers(0, KNRM_WORDS, KNRM_L2)]
            if j < KNRM_RELEVANT:
                body[:KNRM_L1] = words
            docs.append(TextFeature(" ".join(body), uri=f"d{qi}-{j}"))
            relations.append(Relation(f"q{qi}", f"d{qi}-{j}",
                                      int(j < KNRM_RELEVANT)))
    q = TextSet.array(queries).tokenize().normalize().word2idx() \
        .shape_sequence(KNRM_L1)
    d = TextSet.array(docs).tokenize().normalize() \
        .word2idx(existing_map=q.get_word_index()).shape_sequence(KNRM_L2)
    return q, d, relations


def knrm_ranking_leg(seed):
    """KNRM's ranking route as the reference takes it: the zoo model's
    graph under ``TimeDistributed`` (input (2, L1 + L2): a relevant and
    an irrelevant document for one query), trained by ``fit`` with
    ``rank_hinge`` on a ``from_relation_pairs`` TextSet, whose samples
    keep each pair whole through the shuffle; then NDCG@3 and MAP on a
    ``from_relation_lists`` TextSet, on the card and on the CPU twin of
    the trained weights (the wrapper trains KNRM's own)."""
    rs = np.random.default_rng(seed)
    t0 = time.perf_counter()
    q, d, relations = knrm_corpora(rs)
    pairs = TextSet.from_relation_pairs(relations, q, d)
    lists = TextSet.from_relation_lists(relations, q, d)
    text_s = time.perf_counter() - t0
    words = len(d.get_word_index())
    if len(pairs) < KNRM_PAIRS or words >= KNRM_VOCAB or \
            len(lists) != KNRM_QUERIES:
        raise AssertionError(f"KNRM corpora: {len(pairs)} pairs, {words} "
                             f"words, {len(lists)} lists")
    knrm = seeded_zoo_model(lambda: KNRM(
        KNRM_L1, KNRM_L2, KNRM_VOCAB, embed_size=KNRM_EMBED,
        kernel_num=KNRM_KERNELS, target_mode="ranking"), seed)
    ranker = Sequential()
    ranker.add(L.TimeDistributed(knrm.model,
                                 input_shape=(2, KNRM_L1 + KNRM_L2)))
    x = pairs.to_feature_set().features[0]
    _, err = check_predict("KNRM(ranking)", ranker, x, len(pairs))
    ranker.compile(Adam(lr=1e-3), "rank_hinge")
    fit = fit_one_batch("KNRM(ranking)", ranker, pairs, None, len(pairs),
                        SEQ_FIT_STEPS)
    twin = zoo_twin(knrm)
    ndcg, ndcg_cpu = knrm.evaluate_ndcg(lists, 3), \
        twin.evaluate_ndcg(lists, 3)
    mean_ap, map_cpu = knrm.evaluate_map(lists), twin.evaluate_map(lists)
    if abs(ndcg - ndcg_cpu) > 1e-6 or abs(mean_ap - map_cpu) > 1e-6:
        raise AssertionError(f"KNRM(ranking): NDCG@3 {ndcg} / {ndcg_cpu}, "
                             f"MAP {mean_ap} / {map_cpu} on the card / "
                             "the CPU")
    return dict(target_mode="ranking", loss="rank_hinge",
                route="TimeDistributed(knrm.model) on TextSet "
                      "from_relation_pairs", pairs=len(pairs),
                batch=len(pairs), queries=KNRM_QUERIES,
                documents=len(d), words=words, text_pipeline_s=text_s,
                text1_length=KNRM_L1, text2_length=KNRM_L2,
                vocab=KNRM_VOCAB, embed_size=KNRM_EMBED,
                kernel_num=KNRM_KERNELS, predict_cpu_max_abs_err=err,
                ndcg_at_3=ndcg, ndcg_at_3_cpu=ndcg_cpu, map=mean_ap,
                map_cpu=map_cpu, query_lists=len(lists), **fit)


def knrm_leg(seed, target_mode, loss):
    rs = np.random.default_rng(seed)
    x, y = knrm_pairs(rs, KNRM_PAIRS)
    model = seeded_zoo_model(lambda: KNRM(
        KNRM_L1, KNRM_L2, KNRM_VOCAB, embed_size=KNRM_EMBED,
        kernel_num=KNRM_KERNELS, target_mode=target_mode), seed)
    _, err = check_predict(f"KNRM({target_mode})", model, x, KNRM_PAIRS)
    model.compile(Adam(lr=1e-3), loss)
    fit = fit_one_batch(f"KNRM({target_mode})", model, x, y, KNRM_PAIRS,
                        SEQ_FIT_STEPS)
    # ranking on the card against the CPU twin of the trained weights
    groups = [knrm_group(rs) for _ in range(KNRM_QUERIES)]
    twin = zoo_twin(model)
    ndcg, ndcg_cpu = model.evaluate_ndcg(groups, 3), \
        twin.evaluate_ndcg(groups, 3)
    mean_ap, map_cpu = model.evaluate_map(groups), twin.evaluate_map(groups)
    if abs(ndcg - ndcg_cpu) > 1e-6 or abs(mean_ap - map_cpu) > 1e-6:
        raise AssertionError(f"KNRM({target_mode}): NDCG@3 {ndcg} / "
                             f"{ndcg_cpu}, MAP {mean_ap} / {map_cpu} on "
                             "the card / the CPU")
    return dict(target_mode=target_mode, loss=loss, batch=KNRM_PAIRS,
                text1_length=KNRM_L1, text2_length=KNRM_L2,
                vocab=KNRM_VOCAB, embed_size=KNRM_EMBED,
                kernel_num=KNRM_KERNELS, predict_cpu_max_abs_err=err,
                ndcg_at_3=ndcg, ndcg_at_3_cpu=ndcg_cpu, map=mean_ap,
                map_cpu=map_cpu, query_groups=KNRM_QUERIES, **fit)


def session_leg(seed):
    rs = np.random.default_rng(seed)
    sess = rs.integers(1, SR_ITEMS + 1, (SR_BATCH, SR_SESSION)) \
        .astype(np.int32)
    hist = rs.integers(1, SR_ITEMS + 1, (SR_BATCH, SR_HISTORY)) \
        .astype(np.int32)
    y = (sess[:, -1] - 1).astype(np.int32)
    model = seeded_zoo_model(lambda: SessionRecommender(
        SR_ITEMS, SR_EMBED, session_length=SR_SESSION, include_history=True,
        history_length=SR_HISTORY), seed)
    _, err = check_predict("SessionRecommender", model, [sess, hist],
                           SR_BATCH)
    model.compile(Adam(lr=1e-3), "sparse_categorical_crossentropy")
    fit = fit_one_batch("SessionRecommender", model, [sess, hist], y,
                        SR_BATCH, SEQ_FIT_STEPS)
    samples = [Sample([s, h]) for s, h in zip(sess[:SR_RECOMMEND],
                                              hist[:SR_RECOMMEND])]
    recs = model.recommend_for_session(samples, SR_MAX_ITEMS)
    want = zoo_twin(model).recommend_for_session(samples, SR_MAX_ITEMS)
    same = [[i for i, _ in r] for r in recs] == \
        [[i for i, _ in r] for r in want]
    prob_err = float(np.abs(np.array([[p for _, p in r] for r in recs]) -
                            np.array([[p for _, p in r] for r in want]))
                     .max())
    if not same or prob_err > SEQ_CPU_TOL:
        raise AssertionError(f"recommend_for_session on the card: items "
                             f"equal {same}, probabilities off by "
                             f"{prob_err}")
    return dict(items=SR_ITEMS, item_embed=SR_EMBED,
                rnn_hidden_layers=[40, 20], mlp_hidden_layers=[40, 20],
                session_length=SR_SESSION, history_length=SR_HISTORY,
                batch=SR_BATCH, predict_cpu_max_abs_err=err,
                recommend_sessions=SR_RECOMMEND, max_items=SR_MAX_ITEMS,
                recommendations_equal_cpu=same,
                recommendation_prob_max_err=prob_err, **fit)


def seq2seq_leg(seed):
    def make():
        return Seq2seq(
            RNNEncoder.initialize("lstm", S2S_LAYERS, S2S_HIDDEN),
            RNNDecoder.initialize("lstm", S2S_LAYERS, S2S_HIDDEN),
            [S2S_T_IN, S2S_FEAT], [S2S_T_OUT, S2S_FEAT],
            bridge=Bridge("dense", S2S_HIDDEN),
            generator=L.TimeDistributed(L.Dense(S2S_FEAT)))

    rs = np.random.default_rng(seed)
    x_enc = rs.standard_normal((S2S_BATCH, S2S_T_IN, S2S_FEAT)) \
        .astype(np.float32)
    x_dec = rs.standard_normal((S2S_BATCH, S2S_T_OUT, S2S_FEAT)) \
        .astype(np.float32)
    y = np.roll(x_dec, -1, axis=1)
    model = seeded_zoo_model(make, seed)
    _, err = check_predict("Seq2seq", model, [x_enc, x_dec], S2S_BATCH)
    model.compile(Adam(lr=1e-3), "mse")
    fit = fit_one_batch("Seq2seq", model, [x_enc, x_dec], y, S2S_BATCH,
                        SEQ_FIT_STEPS)
    start = rs.standard_normal(S2S_FEAT).astype(np.float32)
    src = x_enc[:S2S_INFER_ROWS]
    t0 = time.perf_counter()
    got = model.infer(src, start, max_seq_len=S2S_INFER_LEN)
    infer_s = time.perf_counter() - t0
    # the same weights' infer on the CPU
    twin = zoo_twin(model)
    layers = {l.name: l for l in twin.model.graph_function().layers}
    for role in ("encoder", "decoder", "bridge", "generator"):
        setattr(twin, role, layers[getattr(model, role).name])
    want = twin.infer(src, start, max_seq_len=S2S_INFER_LEN)
    cpu_err = float(np.abs(got - want).max())
    # the reference's loop on the card, one row, stopped by a token of
    # its own stream
    free = model.infer_reference(src[0], start, max_seq_len=6)
    stop = free[0, 4]
    ref = model.infer_reference(src[0], start, max_seq_len=S2S_INFER_LEN,
                                stop_sign=stop)
    cached = model.infer(src[0], start, max_seq_len=S2S_INFER_LEN,
                         stop_sign=stop)
    ref_err = float(np.abs(ref - cached).max()) \
        if ref.shape == cached.shape else float("inf")
    launches = no_launches("Seq2seq infer")
    if got.shape != (S2S_INFER_ROWS, S2S_INFER_LEN + 1, S2S_FEAT) or \
            not np.isfinite(got).all() or cpu_err > SEQ_CPU_TOL or \
            ref.shape != (1, 5, S2S_FEAT) or \
            ref_err > S2S_REFERENCE_TOL or launches:
        raise AssertionError(
            f"Seq2seq infer: shape {got.shape}, off the CPU by {cpu_err}; "
            f"with the stop sign {ref.shape} / {cached.shape}, off the "
            f"reference loop by {ref_err}; launches {launches}")
    return dict(rnn_type="lstm", nlayers=S2S_LAYERS, hidden=S2S_HIDDEN,
                bridge="dense", generator="TimeDistributed(Dense)",
                feat=S2S_FEAT, t_in=S2S_T_IN, t_out=S2S_T_OUT,
                batch=S2S_BATCH, predict_cpu_max_abs_err=err,
                infer_rows=S2S_INFER_ROWS, infer_len=S2S_INFER_LEN,
                infer_s=infer_s, infer_cpu_max_abs_err=cpu_err,
                infer_reference_steps=int(ref.shape[1]),
                infer_reference_max_abs_err=ref_err, **fit)


def sequence(seed, smi):
    """The sequence phase: the TextClassifier leg at news20's widths for
    each encoder, timed in alternating windows; then AnomalyDetector,
    KNRM (both target modes), SessionRecommender and Seq2seq. The launch
    counts are set to 0 as it starts and read as it ends, so every
    predict, fit, evaluate, timed and profiled step and infer of the
    phase is counted. Returns the report and K1-K5's launches over the
    phase (none, or it fails)."""
    t0 = time.perf_counter()
    _kernels.LAUNCHES.reset()
    table = np.random.default_rng(seed + 40).standard_normal(
        (TC_MAX_WORDS + 1, TC_TOKEN_LEN)).astype(np.float32)
    x, y = text_data(seed + 41, TC_BATCH)
    models, legs = {}, {}
    for i, encoder in enumerate(TC_ENCODERS):
        models[encoder], legs[encoder] = text_classifier_leg(
            encoder, seed + 42 + i, table, x, y)
    timing = time_text_classifiers(models, x, y)
    del models
    collect()
    others = dict(
        anomaly_detector=anomaly_leg(seed + 45),
        knrm_ranking=knrm_ranking_leg(seed + 46),
        knrm_classification=knrm_leg(seed + 47, "classification",
                                     "binary_crossentropy"),
        session_recommender=session_leg(seed + 48),
        seq2seq=seq2seq_leg(seed + 49))
    collect()
    launches = no_launches("the sequence phase")
    return dict(
        card=smi, model="TextClassifier (text_classification.py, news20)",
        classes=TC_CLASSES, sequence_length=TC_SEQ_LEN,
        token_length=TC_TOKEN_LEN, max_words=TC_MAX_WORDS,
        encoder_output_dim=TC_ENCODER_DIM, batch=TC_BATCH,
        optimizer=f"adagrad lr {TC_LR}",
        loss="sparse_categorical_crossentropy", steps=TC_STEPS,
        compute_dtype="float32",
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        text_classifier=legs, timing=timing, **others,
        k1_k5_launches=launches,
        clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                          "temperature.gpu"),
        wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

# bench.py's ResNet-50 leg (bench_resnet_mfu :551, _bench_resnet_mfu_at
# :601): ImageClassifier(class_num=1000, model_name="resnet-50") on
# 3 x 224 x 224 NCHW, bf16 over float32 weights, SGD at its default lr
# 0.01, sparse categorical cross-entropy, seeded N(0, 1) images and int32
# labels in [0, 1000); batch 256, the JAX package's own measured batch.
# Its FLOP count a step is 3 x 2 x 4.09e9 x batch (bench.py:548, :646).
RESNET_CLASSES, RESNET_SHAPE = 1000, (3, 224, 224)
RESNET_BATCH, RESNET_STEPS = 256, 8
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.09e9
RESNET_PARITY_ROWS, RESNET_PREDICT_ROWS = 2, 8
# one train_step, card against the port's CPU run, on RESNET_PARITY_SEEDS
# draws of the start (weights, the last gamma of each residual branch
# from U(RESNET_BRANCH_GAMMA), 2 images), so that every parameter carries
# a gradient. Whole model: (loss, moving statistics); float32 sums in
# another order, bf16 rounds at other places. The gradients are held
# layer by layer (utils/layer_parity.py): each layer's output, input
# gradients and parameter gradients from the card's own inputs, over the
# CPU's norm: float32 1e-4 (measured up to 9.8e-6 over the 3 starts,
# NVIDIA H100 80GB HBM3), bf16 2e-2 (measured up to 4.1e-3, where bf16
# arithmetic alone moves the CPU's layers up to 3.4e-3 from float32; the
# fused backward on NCHW bf16, which rounds dgamma and dbeta through
# bf16, read 5.1e-2). Whole-model gradients are reported, not gated: one
# float32 step of this ResNet-50 lands 0.4-0.7% of a gradient's norm
# from the float64 one on the CPU alone, as ReLU masks near zero flip
# (tools/resnet_grad_conditioning.py).
RESNET_PARITY_SEEDS = 3
RESNET_BRANCH_GAMMA = (0.1, 0.25)
RESNET_STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
RESNET_LAYER_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RESNET_PREDICT_TOL = 1e-4
RESNET_ROW_SUM_TOL = 1e-3
RESNET_TIMED_STEPS = 5


def conv_kernel_group(name: str) -> str:
    """The ResNet step's kernels by what they do, from their symbols:
    cuDNN's convolutions (forward, backward data, backward filter) and
    its NCHW <-> NHWC layout transposes, cuBLAS, PyTorch's batch norm
    kernels, pooling, reductions (the loss, the layout copies' sums) and
    elementwise kernels (ReLU, the adds, casts, SGD)."""
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout transposes (cuDNN)"
    if "wgrad" in low:
        return "convolution backward filter"
    if "dgrad" in low:
        return "convolution backward data"
    if any(s in low for s in ("fprop", "implicit_convolve", "winograd",
                              "convolve", "conv2d")):
        return "convolution forward"
    if any(s in low for s in ("cudnn", "xmma", "cutlass")):
        return "convolution (other cuDNN)"
    if any(s in low for s in ("gemm", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "batch_norm" in low:
        return "batch norm"
    if "pool" in low:
        return "pooling"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def draw_branch_gammas(model, seed):
    """The gamma of the last BatchNorm of every bottleneck branch drawn
    from U(RESNET_BRANCH_GAMMA) (0.1-0.25 of the Keras init of 1): small
    enough to keep the step's activations moderate, nonzero so that every
    convolution and BatchNorm in a branch carries a gradient."""
    gen = torch.Generator().manual_seed(seed)
    lo, hi = RESNET_BRANCH_GAMMA
    with torch.no_grad():
        for node in model.graph_function().nodes:
            if isinstance(node.layer, L.Add):
                gamma = node.inputs[0].node.layer.gamma
                gamma.copy_(lo + (hi - lo) * torch.rand(gamma.shape,
                                                        generator=gen))


def resnet_twin(model):
    """A second build of ResNet-50 on the CPU holding ``model``'s weights
    and moving statistics (copied in order: ``copy.deepcopy`` recurses
    once a graph node deep, too deep for this graph)."""
    twin = ImageClassifier(class_num=RESNET_CLASSES,
                           model_name="resnet-50").model
    with torch.no_grad():
        for mine, theirs in ((twin.parameters(), model.parameters()),
                             (twin.buffers(), model.buffers())):
            for a, b in zip(mine, theirs):
                a.copy_(b.detach().cpu())
    return twin


def resnet_data(seed, n):
    """bench.py:616-617: N(0, 1) float32 images, int32 labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + RESNET_SHAPE).astype(np.float32)
    y = rng.integers(0, RESNET_CLASSES, (n,)).astype(np.int32)
    return x, y


def build_resnet(seed):
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    clf = ImageClassifier(class_num=RESNET_CLASSES, model_name="resnet-50")
    config.seed = seed0     # the model drew its weights from seed
    return clf


def check_resnet_parity(seed, device):
    """ResNet-50 on the card against the port's CPU run from the same
    weights and seeded moving statistics: ``predict`` of
    RESNET_PREDICT_ROWS images in float32; then, on RESNET_PARITY_SEEDS
    starts (``draw_branch_gammas``), one SGD ``train_step`` on
    RESNET_PARITY_ROWS images in float32 and in bf16: the loss and every
    moving statistic after the step, every layer's forward and backward
    from the card's own inputs (``compare_layers``; in bf16 also how far
    bf16 arithmetic alone moves the CPU's layers from float32), a nonzero
    CPU gradient on every convolution kernel, and no launch of K1-K5."""
    clf = build_resnet(seed + 20)
    gen = torch.Generator().manual_seed(seed + 21)
    with torch.no_grad():
        for name, b in clf.model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5
                    if name.endswith("moving_var") else
                    0.2 * torch.randn(b.shape, generator=gen))
    x, y = resnet_data(seed + 22, RESNET_PREDICT_ROWS)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    cpu_model = resnet_twin(clf.model)
    got = clf.predict(x, batch_size=RESNET_PREDICT_ROWS)
    want = SPMDTrainer(cpu_model, loss_fn, get_optimizer("sgd"),
                       device="cpu").predict(x, RESNET_PREDICT_ROWS)
    predict_err = float(np.abs(got - want).max())
    out = dict(predict_rows=RESNET_PREDICT_ROWS,
               predict_max_abs_err=predict_err,
               predict_tol=RESNET_PREDICT_TOL,
               branch_gamma=RESNET_BRANCH_GAMMA, steps=[])
    if got.shape != (RESNET_PREDICT_ROWS, RESNET_CLASSES) or \
            not predict_err <= RESNET_PREDICT_TOL:
        emit("resnet_parity", ok=False, **out)
        raise AssertionError(f"ResNet-50 predict on the card differs from "
                             f"the CPU by {predict_err}")
    for k in range(RESNET_PARITY_SEEDS):
        start = resnet_twin(clf.model)
        draw_branch_gammas(start, seed + 30 + k)
        xk, yk = resnet_data(seed + 40 + k, RESNET_PARITY_ROWS)
        rows = ([xk], yk, np.ones(RESNET_PARITY_ROWS, np.float32))
        for dtype in ("float32", "bfloat16"):
            res = resnet_step_parity(start, rows, device, dtype)
            res.update(seed=seed + 30 + k)
            out["steps"].append(res)
            if not res["ok"]:
                emit("resnet_parity", ok=False, **out)
                raise AssertionError(f"ResNet-50 {dtype} step on the card "
                                     f"differs from the CPU: {res}")
    return out


def resnet_step_parity(start, rows, device, dtype):
    """One ``train_step`` of copies of ``start`` on the card and on the
    CPU in ``dtype``, the card's layers recorded and held against the
    CPU's (see check_resnet_parity)."""
    loss_fn = get_loss("sparse_categorical_crossentropy")
    card_model, cpu_model = resnet_twin(start), resnet_twin(start)
    card = SPMDTrainer(card_model, loss_fn, get_optimizer("sgd"),
                       device=device, compute_dtype=dtype)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("sgd"),
                      device="cpu", compute_dtype=dtype)
    card.ensure_initialized()
    cpu.ensure_initialized()
    _kernels.LAUNCHES.reset()
    with LayerRecorder(card_model) as recorder:
        card_loss = card.train_step(card.put_batch(rows)).item()
    launches = _kernels.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    cpu_loss = cpu.train_step(cpu.put_batch(rows)).item()
    cpu_s = time.perf_counter() - t0
    layers = compare_layers(
        recorder, resnet_twin(start),
        also_in=torch.float32 if dtype == "bfloat16" else None)
    worst = {"y": (0.0, None), "dx": (0.0, None), "param": (0.0, None)}
    wide = 0.0
    for name, r in layers.items():
        for key, val in [("y", r["y"])] + [("dx", d) for d in r["dx"]
                                           if d is not None] + \
                [("param", r[p]) for p in r["ref_norm"]]:
            if not val <= worst[key][0]:
                worst[key] = (val, name)
        wide = max(wide, r.get("vs_float32", 0.0))
    convs = {n: r["ref_norm"]["kernel"] for n, r in layers.items()
             if n.startswith("convolution2d")}
    zero_kernels = [n for n, norm in convs.items() if not norm > 0.0]
    whole = max(((g.grad.cpu() - q.grad).norm() /
                 max(q.grad.norm().item(), 1e-12)).item()
                for g, q in zip(card_model.parameters(),
                                cpu_model.parameters()))
    finite = all(torch.isfinite(p.grad).all().item()
                 for p in card_model.parameters())
    stats_err = max((b.cpu() - c).abs().max().item()
                    for b, c in zip(card_model.buffers(),
                                    cpu_model.buffers()))
    loss_tol, stats_tol = RESNET_STEP_TOL[dtype]
    layer_tol = RESNET_LAYER_TOL[dtype]
    ok = (not launches and finite and len(convs) == 53 and
          not zero_kernels and
          abs(card_loss - cpu_loss) <= loss_tol and
          stats_err <= stats_tol and
          all(v <= layer_tol for v, _ in worst.values()))
    return dict(ok=ok, dtype=dtype, rows=RESNET_PARITY_ROWS,
                card_loss=card_loss, cpu_loss=cpu_loss,
                loss_err=abs(card_loss - cpu_loss), loss_tol=loss_tol,
                moving_stats_max_abs_err=stats_err, stats_tol=stats_tol,
                layers=len(layers), layer_tol=layer_tol,
                layer_max_rel_err=worst,
                layer_bf16_vs_float32_on_cpu=wide,
                conv_kernels_checked=len(convs),
                conv_kernels_with_zero_cpu_grad=zero_kernels,
                min_conv_kernel_cpu_grad_norm=min(convs.values()),
                whole_model_max_grad_rel_err=whole, grads_finite=finite,
                kernel_launches=launches, cpu_step_s=cpu_s)


def check_float32_leaves(tree, where):
    """Every floating tensor in ``tree`` (dicts and lists of them) is
    float32."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_float32_leaves(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            check_float32_leaves(v, f"{where}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point() and \
            tree.dtype != torch.float32:
        raise AssertionError(f"{where}: {tree.dtype}")


def resnet_fit(seed, x, y):
    """bench.py's configuration through ``compile``/``fit``/``evaluate``/
    ``predict`` in bf16: RESNET_STEPS steps of ``fit`` on one seeded batch
    of RESNET_BATCH images (one epoch a step), with K1-K5's launch counts
    read around the fit."""
    clf = build_resnet(seed + 23)
    clf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    clf.model.set_compute_dtype("bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    clf.fit(x, y, batch_size=RESNET_BATCH, nb_epoch=RESNET_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses = list(clf.model.trainer.step_losses)
    if launches:
        raise AssertionError(f"the ResNet-50 fit launched {launches}")
    if len(losses) != RESNET_STEPS or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 losses {losses}")
    model = clf.model
    stats = model.state_tree()
    moved = {}
    for name, s in stats.items():
        mean, var = s["moving_mean"], s["moving_var"]
        if mean.dtype != torch.float32 or var.dtype != torch.float32 or \
                not torch.isfinite(mean).all() or \
                not torch.isfinite(var).all():
            raise AssertionError(f"{name}: moving statistics {mean.dtype} "
                                 f"{var.dtype}, or not finite")
        moved[name] = min(mean.abs().max().item(),
                          (var - 1).abs().max().item())
    if len(stats) != 53 or min(moved.values()) <= 0.0:
        raise AssertionError(f"moving statistics did not move: {moved}")
    check_float32_leaves(dict(model.named_parameters()), "params")
    check_float32_leaves({n: p.grad for n, p in model.named_parameters()},
                         "grads")
    check_float32_leaves(model.trainer.opt_state, "sgd state")
    kernels = {n: p.grad.abs().max().item()
               for n, p in model.named_parameters()
               if n.endswith(".kernel") and "convolution2d" in n}
    if len(kernels) != 53 or min(kernels.values()) <= 0.0:
        raise AssertionError(f"convolution kernels without a gradient: "
                             f"{[n for n, g in kernels.items() if g <= 0]}")
    results = clf.evaluate(x, y, batch_size=RESNET_BATCH // 2)
    probs = clf.predict(x[:RESNET_BATCH // 4], batch_size=RESNET_BATCH // 4)
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if not np.isfinite(results["loss"]) or \
            probs.shape != (RESNET_BATCH // 4, RESNET_CLASSES) or \
            not row_err <= RESNET_ROW_SUM_TOL:
        raise AssertionError(f"evaluate {results}, predict rows off 1 by "
                             f"{row_err}")
    return clf, dict(
        model="ResNet-50 ImageClassifier (bench.py:551-646)",
        classes=RESNET_CLASSES, input_shape=RESNET_SHAPE, data_format="th",
        compute_dtype="bfloat16", optimizer="sgd lr 0.01",
        loss="sparse_categorical_crossentropy", batch=RESNET_BATCH,
        steps=RESNET_STEPS, seed=seed,
        params=sum(p.numel() for p in model.parameters()), losses=losses,
        k1_k5_launches=launches, fit_wall_s=wall, peak_memory_bytes=peak,
        min_moving_stat_shift=min(moved.values()),
        min_conv_kernel_grad=min(kernels.values()),
        float32_params_grads_and_sgd_state=True, evaluate=results,
        predict_rows=RESNET_BATCH // 4, predict_row_sum_max_err=row_err,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        cudnn_benchmark=torch.backends.cudnn.benchmark)


def time_resnet_dtypes(bf16_clf, seed, x, y):
    """The bf16 step of the fitted model and a float32 model's step at the
    same batch, in alternating windows of RESNET_TIMED_STEPS steps (f32,
    bf16, bf16, f32): host clock around each synchronised step, p50,
    images/s, MFU by bench.py's count, each window's peak memory; then the
    step's device time by kernel group in each dtype, and the bf16
    forward and backward alone, whose difference from the step is the
    SGD update."""
    f32_clf = build_resnet(seed + 24)
    f32_clf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    trainers = {"float32": f32_clf.model._ensure_trainer(),
                "bfloat16": bf16_clf.model.trainer}
    trainers["float32"].ensure_initialized()
    batches = {dt: t.put_batch(([x], y, np.ones(RESNET_BATCH, np.float32)))
               for dt, t in trainers.items()}
    trainers["float32"].train_step(batches["float32"])     # warm-up
    step_s = {dt: [] for dt in trainers}
    peaks = {dt: [] for dt in trainers}
    order = list(trainers)
    for w in range(DTYPE_WINDOWS):
        for dt in (order if w % 2 == 0 else order[::-1]):
            trainer = trainers[dt]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(RESNET_TIMED_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(batches[dt])
                torch.cuda.synchronize()
                step_s[dt].append(time.perf_counter() - t0)
            peaks[dt].append(torch.cuda.max_memory_allocated())
    out = {}
    for dt in trainers:
        p50 = percentile(step_s[dt], 50)
        flops = RESNET_FLOPS_PER_IMAGE * RESNET_BATCH
        out[dt] = dict(batch=RESNET_BATCH,
                       step_ms=[1e3 * t for t in step_s[dt]],
                       step_p50_ms=1e3 * p50,
                       images_per_s=RESNET_BATCH / p50,
                       tflops_per_s=flops / p50 / 1e12,
                       mfu=flops / p50 / PEAK_FLOPS[torch.bfloat16],
                       bound_ms=1e3 * flops / PEAK_FLOPS[torch.bfloat16],
                       peak_memory_bytes=max(peaks[dt]))
    f32 = trainers["float32"]
    out["float32"]["profile"] = profile_device(
        lambda: f32.train_step(batches["float32"]), conv_kernel_group)
    bf16 = trainers["bfloat16"]
    batch = batches["bfloat16"]
    step = profile_device(lambda: bf16.train_step(batch), conv_kernel_group)
    fwd_bwd = profile_device(lambda: bf16.loss_and_grads(batch),
                             conv_kernel_group)
    out["bfloat16"]["profile"] = step
    out["bfloat16"]["forward_backward_profile"] = fwd_bwd
    if step["groups"] and fwd_bwd["groups"]:
        out["bfloat16"]["launches_per_step"] = sum(
            g["launches"] for g in step["groups"].values())
        out["bfloat16"]["sgd_update"] = dict(
            device_ms=step["device_busy_ms"] - fwd_bwd["device_busy_ms"],
            launches=out["bfloat16"]["launches_per_step"] - sum(
                g["launches"] for g in fwd_bwd["groups"].values()))
    out["bf16_speedup_per_image"] = \
        out["bfloat16"]["images_per_s"] / out["float32"]["images_per_s"]
    return dict(windows=DTYPE_WINDOWS, steps_per_window=RESNET_TIMED_STEPS,
                mfu_peak="989 TFLOP/s (bf16 dense, H100 SXM data sheet)",
                flops_per_image=RESNET_FLOPS_PER_IMAGE, **out)


def resnet(seed, device, smi):
    """The resnet phase: parity with the CPU, bench.py's configuration
    through fit in bf16, and the timing of the bf16 and float32 steps."""
    t0 = time.perf_counter()
    parity = check_resnet_parity(seed, device)
    parity_s = time.perf_counter() - t0
    x, y = resnet_data(seed + 25, RESNET_BATCH)
    clf, report = resnet_fit(seed, x, y)
    report["parity"] = parity
    report["parity_s"] = parity_s
    report["timing"] = time_resnet_dtypes(clf, seed, x, y)
    report["clocks"] = nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu")
    emit("resnet", card=smi, **report)


# ---------------------------------------------------------------------------
# 12. cluster serving
# ---------------------------------------------------------------------------

# Cluster Serving's stream: bench.py's ResNet-50 ImageClassifier (predict
# records of one (3, 224, 224) float32 tensor) and the generate phase's
# GPT-width decoder (generate records) served from one file-backed stream
# fed by a client in a second process. Every CS_GEN_EVERY-th record is a
# generate record, with a prompt of CS_MIN_PROMPT-CS_MAX_PROMPT tokens.
CS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_serving")
CS_PREDICTS, CS_GENERATES, CS_GEN_EVERY = 256, 32, 9
CS_MIN_PROMPT, CS_MAX_PROMPT = 32, 448
CS_CONFIG = {"data": {"image_shape": "3, 224, 224"},
             "params": {"batch_size": 16, "top_n": 5, "decode_workers": 2,
                        "warmup": True},
             "generate": {"slots": 8, "max_len": 512, "max_new_tokens": 32}}
CS_BUCKETS = [1, 2, 4, 8, 16]
CS_CLIENT_TIMEOUT_S = 300.0
# the served rows against the port's CPU predict of CS_CPU_ROWS images
# (50 layers of float32 convolutions summed in another order: RESNET_
# PREDICT_TOL), and against the card's own direct predict of every image
# in batches of 16 (the loop pads to other batch shapes, where cuDNN may
# pick another algorithm: probabilities of ~1e-3 move by ~1e-9). Two
# classes whose probabilities lie within the tolerance may trade places
# in the top 5 (a near tie); any other difference in the ids fails.
CS_CPU_ROWS, CS_CPU_TOL, CS_DIRECT_TOL = 16, 1e-4, 1e-5
CS_REFERENCE_STREAMS = 8
CS_REGISTRY_RECORDS, CS_CANARY_WEIGHT = 64, 0.5
# pipelined and synchronous loops in alternating windows (pipelined,
# synchronous, synchronous, pipelined) of CS_WINDOW predict records, all
# queued before the loop starts
CS_WINDOW, CS_WINDOWS = 128, 4


def cs_spec():
    """What makes the stream, handed to the client process whole."""
    return dict(predicts=CS_PREDICTS, generates=CS_GENERATES,
                every=CS_GEN_EVERY, min_prompt=CS_MIN_PROMPT,
                max_prompt=CS_MAX_PROMPT, shape=RESNET_SHAPE,
                vocab=GPT_CONFIG["vocab"])


def cs_images(seed, spec):
    """The stream's images: N(0, 1) float32, as bench.py's ResNet leg."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((spec["predicts"],) + tuple(spec["shape"])) \
        .astype(np.float32)


def cs_stream(seed, spec):
    """[(uri, kind, payload)] in stream order: the images and the
    prompts, every ``spec["every"]``-th record a prompt."""
    n = spec["predicts"] + spec["generates"]
    if n // spec["every"] != spec["generates"]:
        raise ValueError(f"{spec['generates']} prompts are not every "
                         f"{spec['every']}th of {n} records")
    images = cs_images(seed, spec)
    rs = np.random.default_rng(seed + 1)
    prompts = [rs.integers(1, spec["vocab"], size=int(m))
               for m in rs.integers(spec["min_prompt"],
                                    spec["max_prompt"] + 1,
                                    size=spec["generates"])]
    out, i_img = [], 0
    for i in range(n):
        if i % spec["every"] == spec["every"] - 1:
            k = i // spec["every"]
            out.append((f"gen-{k}", "generate", prompts[k]))
        else:
            out.append((f"img-{i_img}", "predict", images[i_img]))
            i_img += 1
    return out


def cs_client(root, seed, spec, results):
    """The client process: InputQueue and OutputQueue over a
    FileStreamQueue at ``root``. Writes the stream as fast as it can, then
    waits for every result; puts {"results": {uri: (value, timing,
    finish, type)}, ...} (or {"error": ...}) on ``results``."""
    from analytics_zoo_tpu_torch.serving.client import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.queue_backend import \
        FileStreamQueue
    try:
        stream = cs_stream(seed, spec)
        q = FileStreamQueue(root)
        iq = InputQueue(backend=q)
        t0 = time.time()
        for uri, kind, payload in stream:
            if kind == "predict":
                iq.enqueue(uri, t=payload)
            else:
                iq.enqueue_generate(uri, payload)
        t_written = time.time()
        got = OutputQueue(backend=q).wait_all(
            [uri for uri, _, _ in stream], timeout=CS_CLIENT_TIMEOUT_S,
            poll=0.005, max_poll=0.05)
        t_done = time.time()
        results.put({"results": {
            uri: (np.asarray(r), r.timing, getattr(r, "finish", None),
                  type(r).__name__) for uri, r in got.items()},
            "write_s": t_written - t0, "wall_s": t_done - t0,
            "leftover": sorted(q.all_results(pop=False)),
            "stream_len": q.stream_len()})
    except Exception:  # noqa: BLE001 - reported to the parent
        import traceback
        results.put({"error": traceback.format_exc()})


def top_ids_agree(got_row, probs, tol):
    """A served top-n row ([[id, p], ...]) against a probability vector:
    (the largest probability error, the places where the ids differ by a
    near tie, and whether every other place agrees). The ids must equal
    the top-n of ``probs`` except where two classes' probabilities lie
    within ``tol``."""
    ids = got_row[:, 0].astype(np.int64)
    want = np.argsort(probs)[::-1][:len(ids)]
    err = float(np.abs(got_row[:, 1] - probs[ids]).max())
    ties, ok = 0, True
    for a, b in zip(ids, want):
        if a != b:
            if abs(probs[a] - probs[b]) <= tol:
                ties += 1
            else:
                ok = False
    return err, ties, ok and err <= tol


def check_served_rows(name, served, uris, probs, tol):
    """Every served predict row against ``probs`` (rows in ``uris``'s
    order): the largest error and the count of near ties; fails past
    ``tol``."""
    worst, ties, bad = 0.0, 0, []
    for uri, p in zip(uris, probs):
        err, t, ok = top_ids_agree(served[uri], p, tol)
        worst, ties = max(worst, err), ties + t
        if not ok:
            bad.append(uri)
    if bad:
        raise AssertionError(f"{name}: rows {bad[:5]} differ (largest "
                             f"probability error {worst}, tol {tol})")
    return dict(rows=len(uris), max_abs_err=worst, tol=tol, near_ties=ties)


def cs_direct_predict(im, x, batch=16):
    return np.concatenate([im.predict(x[i:i + batch])
                           for i in range(0, len(x), batch)])


def cs_window(im, x, pipelined):
    """One timing window: len(x) predict records queued on an in-process
    stream, then a loop of the CS_CONFIG model started and stopped after
    the last result: records/s, per-row queue/device/server ms, buckets."""
    config = copy.deepcopy(CS_CONFIG)
    config["params"]["pipelined"] = pipelined
    backend = InProcessStreamQueue()
    iq = InputQueue(backend=backend)
    uris = [f"w-{i}" for i in range(len(x))]
    for uri, row in zip(uris, x):
        iq.enqueue(uri, t=row)
    server = ClusterServing(model=im,
                            helper=ClusterServingHelper(config=config),
                            backend=backend)
    t0 = time.perf_counter()
    server.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120,
                                                poll=0.001, max_poll=0.005)
    wall = time.perf_counter() - t0
    server.stop()
    if len(got) != len(uris):
        raise AssertionError(f"timing window: {len(got)} of {len(uris)} "
                             f"results")
    timing = {k: [r.timing[k] for r in got.values()]
              for k in ("queue_ms", "device_ms", "server_ms")}
    out = dict(pipelined=pipelined, records=len(uris), wall_s=wall,
               records_per_s=len(uris) / wall,
               buckets=server.pipeline_stats()["buckets"])
    for k, v in timing.items():
        out[f"{k}_p50"] = percentile(v, 50)
        out[f"{k}_p95"] = percentile(v, 95)
    return out


def cs_registry_leg(seed, x, dirs):
    """The registry leg on the in-process transport: v1 then v2 (a canary
    of CS_CANARY_WEIGHT) of "resnet50" behind RoutedClusterServing, 64
    records served, each against its own version's direct predict; the
    canary's share against crc32 of the uris; v2 promoted and v1
    undeployed after its drain, and the manifest then lists v2 alone."""
    root = os.path.join(CS_ROOT, "registry")
    registry = ModelRegistry(root=root)
    backend = InProcessStreamQueue()
    serving = RoutedClusterServing(
        registry, helper=ClusterServingHelper(config=CS_CONFIG),
        backend=backend)
    t0 = time.perf_counter()
    serving.deploy("resnet50", path=dirs[0])
    serving.deploy("resnet50", path=dirs[1], canary_weight=CS_CANARY_WEIGHT)
    deploy_s = time.perf_counter() - t0
    uris = [f"reg-{i}" for i in range(CS_REGISTRY_RECORDS)]
    iq = InputQueue(backend=backend)
    for uri, row in zip(uris, x):
        iq.enqueue(uri, model="resnet50", t=row)
    serving.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120)
    serving.stop()
    stats = serving.pipeline_stats()
    if len(got) != len(uris) or stats["dead_letters"] or stats["dropped"]:
        raise AssertionError(f"registry leg: {len(got)} results, "
                             f"{stats['dead_letters']} dead letters")
    versions = registry._models["resnet50"]
    direct = {v: cs_direct_predict(versions[v].model, x) for v in (1, 2)}
    routed = {u: 2 if zlib.crc32(u.encode()) % 10000 / 10000.0 <
              CS_CANARY_WEIGHT else 1 for u in uris}
    rows = {v: [i for i, u in enumerate(uris) if routed[u] == v]
            for v in (1, 2)}
    checks = {f"v{v}": check_served_rows(
        f"registry v{v}", {u: np.asarray(got[u]) for u in uris},
        [uris[i] for i in rows[v]], direct[v][rows[v]], CS_DIRECT_TOL)
        for v in (1, 2)}
    served = {v: versions[v].requests for v in (1, 2)}
    if served != {v: len(rows[v]) for v in (1, 2)}:
        raise AssertionError(f"canary split {served}, crc32 of the uris "
                             f"gives {[len(rows[v]) for v in (1, 2)]}")
    registry.promote("resnet50", 2)
    removed = registry.undeploy("resnet50", 1)
    with open(os.path.join(root, ModelRegistry.MANIFEST)) as f:
        manifest = json.load(f)["models"]["resnet50"]
    listed = [v["version"] for v in manifest["versions"]]
    if removed != [1] or listed != [2] or manifest["active"] != 2 or \
            manifest["canary"] is not None:
        raise AssertionError(f"after promote and undeploy: removed "
                             f"{removed}, manifest {manifest}")
    return dict(records=len(uris), deploy_s=deploy_s,
                canary_weight=CS_CANARY_WEIGHT, routed_v2=served[2],
                routed_v1=served[1], rows=checks,
                manifest_versions=listed, buckets=stats["buckets"])


def cluster_serving(seed, device, smi):
    """The cluster_serving phase: the main run (file transport, a client
    process, predict and generate records from one stream), the registry
    leg, and the timing of the pipelined and synchronous loops. Returns
    K1-K5's launches in the main run."""
    shutil.rmtree(CS_ROOT, ignore_errors=True)
    os.makedirs(CS_ROOT)
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    dirs = []
    for k in range(2):
        clf = build_resnet(seed + k)
        dirs.append(os.path.join(CS_ROOT, f"resnet50-v{k + 1}"))
        clf.save_model(dirs[-1])
        del clf
    im = InferenceModel().load(dirs[0])
    if im.model.device != device:
        raise AssertionError(f"InferenceModel.load put it on "
                             f"{im.model.device}")
    layer = build_decoder(seed)
    server = ClusterServing(model=im,
                            helper=ClusterServingHelper(config=CS_CONFIG),
                            backend=FileStreamQueue(
                                os.path.join(CS_ROOT, "stream")))
    server.build_transformer_engine(layer)
    engine = server._gen_engine
    setup_s = time.perf_counter() - t0
    warm = server.warmup() if server.helper.warmup else {}
    if sorted(warm) != CS_BUCKETS:
        raise AssertionError(f"warmup returned buckets {sorted(warm)}")

    # the main run: the client process writes the stream and waits
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    spec = cs_spec()
    client = ctx.Process(target=cs_client, args=(
        os.path.join(CS_ROOT, "stream"), seed, spec, results))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    server.start()
    client.start()
    try:
        reply = results.get(timeout=CS_CLIENT_TIMEOUT_S + 120)
    finally:
        client.join(timeout=60)
        if client.is_alive():
            client.kill()
        server.stop()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    prefills = engine.prefill_calls
    if "error" in reply:
        raise AssertionError(f"the client process failed: {reply['error']}")
    stats = server.pipeline_stats()
    gen_stats = stats.get("generation", {})
    stream = cs_stream(seed, spec)
    got = reply["results"]
    expected = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * prefills}
    integrity = dict(
        results=len(got), uris=len(stream),
        results_out=stats["results_out"], records_in=stats["records_in"],
        dropped=stats["dropped"], dead_letters=stats["dead_letters"],
        shed=stats["shed"], queue=stats["queue"],
        committed=gen_stats.get("committed"),
        duplicate_commits=gen_stats.get("duplicate_commits"),
        leftover_results=reply["leftover"],
        stream_len=reply["stream_len"])
    if sorted(got) != sorted(u for u, _, _ in stream) or \
            stats["results_out"] != len(stream) or \
            stats["records_in"] != len(stream) or \
            stats["dropped"] or stats["dead_letters"] or stats["shed"] or \
            stats["queue"]["duplicates"] or stats["queue"]["seq_gaps"] or \
            gen_stats.get("committed") != CS_GENERATES or \
            gen_stats.get("duplicate_commits") or reply["leftover"] or \
            reply["stream_len"]:
        emit("cluster_serving", check="main run", ok=False, **integrity)
        raise AssertionError(f"cluster serving main run: {integrity}")
    if launches != expected:
        raise AssertionError(f"cluster serving launches {launches}, "
                             f"expected {expected} ({prefills} prefills)")

    # the predict rows: all against the card's direct predict, the first
    # CS_CPU_ROWS against the port's CPU predict
    img_uris = [u for u, kind, _ in stream if kind == "predict"]
    x = cs_images(seed, spec)
    served = {u: got[u][0] for u in img_uris}
    if any(got[u][3] != "ServingResult" or served[u].shape != (5, 2)
           for u in img_uris):
        raise AssertionError("a predict result is not a top-5 row")
    direct = cs_direct_predict(im, x)
    direct_check = check_served_rows("direct predict", served, img_uris,
                                     direct, CS_DIRECT_TOL)
    cpu_model = SPMDTrainer(resnet_twin(im.model.model),
                            get_loss("sparse_categorical_crossentropy"),
                            get_optimizer("sgd"), device="cpu")
    cpu_probs = cpu_model.predict(x[:CS_CPU_ROWS], CS_CPU_ROWS)
    cpu_check = check_served_rows("CPU predict", served,
                                  img_uris[:CS_CPU_ROWS], cpu_probs,
                                  CS_CPU_TOL)
    del cpu_model

    # the generate streams: against the scheduler alone on the same
    # engine, and CS_REFERENCE_STREAMS of them against greedy_reference
    gens = [(u, p) for u, kind, p in stream if kind == "generate"]
    streams = {}
    for u, _ in gens:
        value, _, finish, kind = got[u]
        if kind != "GenerationResult" or finish != "max_new_tokens" or \
                len(value) != CS_CONFIG["generate"]["max_new_tokens"]:
            raise AssertionError(f"{u}: {kind}, {finish}, {len(value)} "
                                 f"tokens")
        streams[f"g{len(streams)}"] = [int(t) for t in value]
    prompts = [p for _, p in gens]
    alone, _, _ = run_scheduler(engine, prompts,
                                CS_CONFIG["generate"]["max_new_tokens"],
                                max_slots=CS_CONFIG["generate"]["slots"])
    check_streams("cluster serving against the scheduler alone", layer,
                  prompts, streams,
                  {u: p["tokens"] for u, p in alone.items()})
    refs = {f"g{i}": greedy_reference(
        layer, prompts[i], CS_CONFIG["generate"]["max_new_tokens"])[0]
        for i in range(CS_REFERENCE_STREAMS)}
    check_streams("cluster serving against greedy_reference", layer,
                  prompts[:CS_REFERENCE_STREAMS],
                  {u: streams[u] for u in refs}, refs)
    ttft = [got[u][1]["ttft_ms"] for u, _ in gens]
    e2e = [got[u][1]["done_ts_ms"] - got[u][1]["enqueue_ts_ms"]
           for u, _ in gens]
    gen_span_s = (max(got[u][1]["done_ts_ms"] for u, _ in gens) -
                  min(got[u][1]["enqueue_ts_ms"] for u, _ in gens)) / 1e3
    rows = {k: [got[u][1][k] for u in img_uris]
            for k in ("queue_ms", "device_ms", "server_ms")}
    main = dict(
        records=len(stream), predicts=CS_PREDICTS, generates=CS_GENERATES,
        prompt_lengths=[int(p.size) for p in prompts], setup_s=setup_s,
        warmup_s=warm, launches=launches, launches_expected=expected,
        prefills=prefills, wall_s=wall, client_write_s=reply["write_s"],
        client_wall_s=reply["wall_s"],
        records_per_s=len(stream) / reply["wall_s"],
        buckets=stats["buckets"], direct=direct_check, cpu=cpu_check,
        reference_streams=CS_REFERENCE_STREAMS,
        ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
        generate_e2e_p50_ms=percentile(e2e, 50),
        generate_e2e_p95_ms=percentile(e2e, 95),
        generate_tokens_per_s=CS_GENERATES *
        CS_CONFIG["generate"]["max_new_tokens"] / gen_span_s,
        peak_memory_bytes=peak, **integrity)
    for k, v in rows.items():
        main[f"predict_{k}_p50"] = percentile(v, 50)
        main[f"predict_{k}_p95"] = percentile(v, 95)
    emit("cluster_serving", check="main run", ok=True,
         model="ImageClassifier(1000, 'resnet-50') and TransformerLayer "
               "(GPT-1 widths)", config=CS_CONFIG, seed=seed, card=smi,
         **main)
    del server

    # the registry leg
    registry = cs_registry_leg(seed, x[:CS_REGISTRY_RECORDS], dirs)
    emit("cluster_serving", check="registry", ok=True, **registry)

    # timing: pipelined against synchronous, alternating windows
    windows = [cs_window(im, x[:CS_WINDOW], pipelined=w in (0, 3))
               for w in range(CS_WINDOWS)]
    prof = profile_device(lambda: cs_window(im, x[:CS_WINDOW], True),
                          conv_kernel_group)
    # across the phase: K1 once a block for every prefill (the loop's, the
    # scheduler's alone and greedy_reference's), K2-K5 never
    phase_launches = _kernels.LAUNCHES.snapshot()
    phase_prefills = engine.prefill_calls + CS_REFERENCE_STREAMS
    want = {attn.KERNEL_NAME: GPT_CONFIG["n_block"] * phase_prefills}
    if phase_launches != want:
        raise AssertionError(f"the cluster_serving phase launched "
                             f"{phase_launches}, expected {want} "
                             f"({phase_prefills} prefills)")
    del layer, engine
    summary = {}
    for mode in (True, False):
        ws = [w for w in windows if w["pipelined"] == mode]
        summary["pipelined" if mode else "synchronous"] = dict(
            records_per_s=[w["records_per_s"] for w in ws],
            **{k: [w[k] for w in ws] for k in ws[0]
               if k.endswith(("_p50", "_p95"))},
            buckets=[w["buckets"] for w in ws])
    emit("timing", path="cluster_serving", card=smi,
         window_records=CS_WINDOW, windows=windows, by_loop=summary,
         main_run=dict(records_per_s=main["records_per_s"],
                       ttft_p50_ms=main["ttft_p50_ms"],
                       ttft_p95_ms=main["ttft_p95_ms"],
                       generate_e2e_p50_ms=main["generate_e2e_p50_ms"],
                       generate_e2e_p95_ms=main["generate_e2e_p95_ms"],
                       generate_tokens_per_s=main["generate_tokens_per_s"],
                       peak_memory_bytes=peak),
         warmup_s=warm, profile=prof, phase_launches=phase_launches,
         phase_prefills=phase_prefills,
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"))
    shutil.rmtree(CS_ROOT)
    return launches


# ---------------------------------------------------------------------------
# int8 inference
# ---------------------------------------------------------------------------

Q_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_int8")
# bench.py's bench_quant models (bench.py:860-880) at its batches,
# calibrated as bench_quant calibrates them: 3 seeded batches of 4
Q_BENCH_CALIB_BATCHES, Q_BENCH_CALIB_ROWS = 3, 4
# VGG-16 and ResNet-50 at full width, ImageClassifier(1000) on 3 x 224 x
# 224, calibrated on 4 seeded batches of 8; 2 images held against the CPU
Q_CALIB_BATCHES, Q_CALIB_ROWS, Q_PARITY_ROWS = 4, 8, 2
Q_VGG_KERNELS, Q_VGG_CHAINS, Q_RESNET_KERNELS = 16, 15, 54
# int8 against float32 on the card, reported only, over this many images
Q_AGREEMENT_ROWS = 16
# a float output of the int8 path against the CPU's from the same int32
# accumulators: float32 epilogue and softmax in another order
Q_FLOAT_TOL = 1e-6
# ResNet-50's int8 rows on the card against the CPU's int8 run from the
# same scales, relative to the row's largest probability, with the same
# top class: BatchNorm runs in float32 between the int8 convolutions, and
# the card's batch norm rounds differently from the CPU's, so an int8
# step may flip at a rounding tie of the next quantize; in the CPU parity
# tests such a flip moved a random-weight ResNet-50's probability by 1.1%
# of the row's largest (tests/test_torch_quantized_model.py)
Q_RESNET_TOL = 2e-2
Q_CS_CONFIG = {"data": {"image_shape": "3, 224, 224"},
               "params": {"batch_size": 16, "top_n": 5, "warmup": True}}
Q_REGISTRY_RECORDS, Q_CANARY_WEIGHT = 64, 0.5
# the timed runs: float32 and calibrated int8 of both models at each
# batch, Q_WINDOW_BATCHES batches a window, the windows alternating
Q_TIMED_BATCHES, Q_WINDOW_BATCHES, Q_WINDOWS = (16, 64), 4, 2


def q_bench_models():
    """bench_quant's MLP (512-1024-1024-128) and CNN (3 x 64 x 64), with
    its layer names, its batches and the JAX package's chain plan for
    them (tests/test_torch_quantized_model.py holds the port's plan
    against JAX's)."""
    def mlp(seed):
        m = Sequential(seed=seed)
        m.add(L.Dense(1024, activation="relu", input_shape=(512,),
                      name="qd1"))
        m.add(L.Dense(1024, activation="relu", name="qd2"))
        m.add(L.Dense(128, activation="relu", name="qout"))
        return m

    def cnn(seed):
        m = Sequential(seed=seed)
        m.add(L.Convolution2D(32, 3, 3, activation="relu",
                              border_mode="same", input_shape=(3, 64, 64),
                              name="qc1"))
        m.add(L.Convolution2D(32, 3, 3, activation="relu",
                              subsample=(2, 2), name="qc2"))
        m.add(L.Flatten())
        m.add(L.Dense(64, activation="relu", name="qcd1"))
        m.add(L.Dense(10, activation="relu", name="qcout"))
        return m

    return {"dense": (mlp, (64, 512), 3,
                      [("qd1", "qd2"), ("qd2", "qout")]),
            "cnn": (cnn, (8, 3, 64, 64), 4,
                    [("qc1", "qc2"), ("qc2", "qcd1"), ("qcd1", "qcout")])}


class Int8Trace:
    """What the int8 path computed in one forward, in order: every int32
    accumulator (``quant.int_product``), every entry quantize's int8
    (``quant._quantize_act``) and every int8 layer output (a requantized
    chain link, pooling, flatten), copied to the host."""

    def __init__(self, model):
        self.layers = model.graph_function().layers

    def __enter__(self):
        self.acc, self.entry, self.act = [], [], []
        self._saved = (quant.int_product, quant._quantize_act)
        product, quantize = self._saved

        def int_product(a, w):
            out = product(a, w)
            self.acc.append(out.cpu())
            return out

        def quantize_act(x, act_scale):
            out = quantize(x, act_scale)
            self.entry.append(out.cpu())
            return out

        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor) and out.dtype == torch.int8:
                self.act.append(out.cpu())

        quant.int_product, quant._quantize_act = int_product, quantize_act
        self._hooks = [layer.register_forward_hook(hook)
                       for layer in self.layers]
        return self

    def __exit__(self, *exc):
        quant.int_product, quant._quantize_act = self._saved
        for h in self._hooks:
            h.remove()
        return False


def compare_traces(card, cpu):
    """Element counts and the share of them that differ, per kind, and the
    largest difference of an int8 value (in quantization steps)."""
    out = {}
    for kind in ("acc", "entry", "act"):
        a, b = getattr(card, kind), getattr(cpu, kind)
        if [t.shape for t in a] != [t.shape for t in b]:
            raise AssertionError(f"int8 traces differ in shape ({kind}): "
                                 f"{len(a)} against {len(b)} tensors")
        n = sum(t.numel() for t in a)
        diff = sum(int((x != y).sum()) for x, y in zip(a, b))
        step = max([int((x.int() - y.int()).abs().max()) for x, y in
                    zip(a, b) if x.numel()] or [0])
        out[kind] = dict(tensors=len(a), elements=n, differing=diff,
                         max_abs_diff=step)
    return out


def q_census(fn):
    with OpCensus() as census:
        out = fn()
    return out, census.int8_summary()


def check_census(name, got, want):
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{name}: the int8 forward ran {got}, "
                             f"expected {want}")
    return got


def cpu_int8_copy(im, directory, model):
    """``model`` saved to ``directory`` with ``im``'s calibration, loaded
    back on the CPU by ``load_quantized``: the port's CPU int8 run from
    the same scales."""
    model.save_model(directory)
    keras_dir = InferenceModel._resolve_model_dir(directory)
    im.save_calibration(os.path.join(keras_dir,
                                     InferenceModel.CALIBRATION_FILE))
    return InferenceModel().load_quantized(directory, device="cpu")


def int8_bench_leg(seed, rs):
    """bench_quant's two models: the chain plan, the forward's structure
    under an op census (one int32 product a kernel, no float product, a
    rounding a chain edge plus the entry quantize, one division), the
    card's int8 outputs against the CPU's from the same scales, and (report
    only) against float32."""
    out = {}
    for key, (make, shape, n_kernels, chains) in q_bench_models().items():
        m = make(seed)
        calib = [rs.standard_normal((Q_BENCH_CALIB_ROWS,) + shape[1:])
                 .astype(np.float32) for _ in range(Q_BENCH_CALIB_BATCHES)]
        x = rs.standard_normal(shape).astype(np.float32)
        f32 = InferenceModel().load_keras_net(m)
        q = InferenceModel().load_keras_net(m, calibration=calib)
        if q.model.chains != chains:
            raise AssertionError(f"{key}: chains {q.model.chains}, the JAX "
                                 f"plan is {chains}")
        got, census = q_census(lambda: q.predict(x))
        check_census(key, census, dict(
            int32_products=n_kernels, float_products=0,
            roundings=len(chains) + 1, divisions=1))
        cpu = cpu_int8_copy(q, os.path.join(Q_ROOT, key), m)
        want = cpu.predict(x)
        err = float(np.abs(got - want).max())
        if err > Q_FLOAT_TOL * max(float(np.abs(want).max()), 1e-30):
            raise AssertionError(f"{key}: int8 on the card off the CPU's "
                                 f"by {err}")
        ref = f32.predict(x)
        out[key] = dict(batch=shape[0], chains=["->".join(c) for c in
                                                 chains],
                        census=census, cpu_max_abs_err=err,
                        rel_err_vs_f32=float(np.mean(np.abs(got - ref)) /
                                             (np.mean(np.abs(ref)) or 1.0)),
                        param_bytes=q.model.param_bytes())
    return out


def build_image_classifier(seed, name):
    config = init_nncontext().config
    seed0, config.seed = config.seed, seed
    clf = ImageClassifier(class_num=RESNET_CLASSES, model_name=name)
    clf.model.graph_function()
    config.seed = seed0     # the model drew its weights from seed
    return clf


def image_batches(rs, n, rows):
    return [rs.standard_normal((rows,) + RESNET_SHAPE).astype(np.float32)
            for _ in range(n)]


def agreement(got, ref):
    """int8 rows against float32 rows: mean relative error and top-1
    agreement."""
    return dict(rel_err=float(np.mean(np.abs(got - ref)) /
                              np.mean(np.abs(ref))),
                top1_agreement=float(np.mean(got.argmax(1) ==
                                             ref.argmax(1))))


def int8_vgg_leg(seed, rs):
    """VGG-16 at full width, the fully chained case: 15 chain edges, 16
    int32 products, one division (the entry quantize) and one softmax;
    2 images against the CPU's int8 run from the same scales (every
    int32 accumulator and int8 activation equal, the softmax within
    Q_FLOAT_TOL); save_calibration then load_quantized (the same chains,
    the rows bit for bit). Returns the report and the models for the
    timed runs."""
    t0 = time.perf_counter()
    clf = build_image_classifier(seed, "vgg-16")
    build_s = time.perf_counter() - t0
    calib = image_batches(rs, Q_CALIB_BATCHES, Q_CALIB_ROWS)
    x = rs.standard_normal((Q_PARITY_ROWS,) + RESNET_SHAPE).astype(
        np.float32)
    f32 = InferenceModel().load_keras_net(clf)
    t0 = time.perf_counter()
    q = InferenceModel().load_keras_net(clf, calibration=calib)
    calibrate_s = time.perf_counter() - t0
    chains = q.model.chains
    if len(q.model.kernels) != Q_VGG_KERNELS or \
            len(chains) != Q_VGG_CHAINS:
        raise AssertionError(f"VGG-16: {len(q.model.kernels)} kernels, "
                             f"chains {chains}")
    _, census = q_census(lambda: q.predict(x))
    check_census("VGG-16", census, dict(
        int32_products=Q_VGG_KERNELS, float_products=0,
        roundings=Q_VGG_CHAINS + 1, divisions=1, softmaxes=1))
    with Int8Trace(clf.model) as card:
        got = q.predict(x)
    directory = os.path.join(Q_ROOT, "vgg16")
    cpu = cpu_int8_copy(q, directory, clf)
    t0 = time.perf_counter()
    with Int8Trace(cpu.model.model) as host:
        want = cpu.predict(x)
    cpu_s = time.perf_counter() - t0
    traces = compare_traces(card, host)
    err = float(np.abs(got - want).max())
    if any(t["differing"] for t in traces.values()) or \
            err > Q_FLOAT_TOL * float(np.abs(want).max()):
        raise AssertionError(f"VGG-16 int8 on the card against the CPU: "
                             f"{traces}, softmax off by {err}")
    reloaded = InferenceModel().load_quantized(directory)
    if reloaded.model.chains != chains or \
            not np.array_equal(reloaded.predict(x), got):
        raise AssertionError("VGG-16: load_quantized of the saved "
                             "directory planned other chains or rows")
    xs = rs.standard_normal((Q_AGREEMENT_ROWS,) + RESNET_SHAPE).astype(
        np.float32)
    report = dict(
        model="ImageClassifier(1000, 'vgg-16')", input=list(RESNET_SHAPE),
        build_s=build_s, calibrate_s=calibrate_s,
        calibration=f"{Q_CALIB_BATCHES} batches of {Q_CALIB_ROWS}",
        kernels=len(q.model.kernels), chains=len(chains), census=census,
        cpu_traces=traces, cpu_softmax_max_abs_err=err, cpu_int8_s=cpu_s,
        reloaded_chains_equal=True,
        vs_f32=agreement(np.concatenate([q.predict(xs[i:i + 8])
                                         for i in range(0, len(xs), 8)]),
                         np.concatenate([f32.predict(xs[i:i + 8])
                                         for i in range(0, len(xs), 8)])),
        param_bytes=q.model.param_bytes())
    del cpu, reloaded
    return report, (f32, q, InferenceModel().load_keras_net(clf,
                                                            quantize=True))


def int8_resnet_leg(seed, rs, device):
    """ResNet-50 at full width, the case with no chains (BatchNorm after
    every convolution: 54 kernels, each quantizing its own input): v1
    float32 and v2 int8 (``deploy(quantize=True)`` of the same
    directory, its calibration.json; a canary of Q_CANARY_WEIGHT) behind
    RoutedClusterServing on the in-process stream, 64 records each
    against its version's direct predict, distinct f32 and int8
    dispatch keys; ``recover(load=True)`` reloads v2 as int8 with equal
    rows; the int8 rows against the CPU's int8 run from the same scales
    (Q_RESNET_TOL). Returns the report and the models for the timed
    runs."""
    clf = build_resnet(seed)
    directory = os.path.join(Q_ROOT, "resnet50")
    clf.save_model(directory)
    calib = image_batches(rs, Q_CALIB_BATCHES, Q_CALIB_ROWS)
    f32 = InferenceModel().load_keras_net(clf)
    t0 = time.perf_counter()
    q = InferenceModel().load_keras_net(clf, calibration=calib)
    calibrate_s = time.perf_counter() - t0
    if len(q.model.kernels) != Q_RESNET_KERNELS or q.model.chains:
        raise AssertionError(f"ResNet-50: {len(q.model.kernels)} kernels, "
                             f"chains {q.model.chains}")
    x = rs.standard_normal((Q_REGISTRY_RECORDS,) + RESNET_SHAPE).astype(
        np.float32)
    _, census = q_census(lambda: q.predict(x[:Q_PARITY_ROWS]))
    check_census("ResNet-50", census, dict(
        int32_products=Q_RESNET_KERNELS, float_products=0,
        roundings=Q_RESNET_KERNELS, divisions=Q_RESNET_KERNELS,
        softmaxes=1))
    keras_dir = InferenceModel._resolve_model_dir(directory)
    q.save_calibration(os.path.join(keras_dir,
                                    InferenceModel.CALIBRATION_FILE))

    root = os.path.join(Q_ROOT, "registry")
    registry = ModelRegistry(root=root)
    backend = InProcessStreamQueue()
    serving = RoutedClusterServing(
        registry, helper=ClusterServingHelper(config=Q_CS_CONFIG),
        backend=backend)
    t0 = time.perf_counter()
    mv1 = serving.deploy("resnet50", path=directory)
    mv2 = serving.deploy("resnet50", path=directory, quantize=True,
                         canary_weight=Q_CANARY_WEIGHT)
    deploy_s = time.perf_counter() - t0
    qm = mv2.model.model
    if (mv1.dtype, mv2.dtype) != ("f32", "int8") or not qm.calibrated or \
            qm.chains or qm.device != device:
        raise AssertionError(f"int8 deploy: dtypes {mv1.dtype}, "
                             f"{mv2.dtype}, calibrated {qm.calibrated}, "
                             f"on {qm.device}")
    uris = [f"q-{i}" for i in range(Q_REGISTRY_RECORDS)]
    iq = InputQueue(backend=backend)
    for uri, row in zip(uris, x):
        iq.enqueue(uri, model="resnet50", t=row)
    serving.start()
    got = OutputQueue(backend=backend).wait_all(uris, timeout=120)
    serving.stop()
    stats = serving.pipeline_stats()
    if len(got) != len(uris) or stats["dead_letters"] or stats["dropped"]:
        raise AssertionError(f"int8 registry: {len(got)} results, "
                             f"{stats['dead_letters']} dead letters")
    direct = {1: cs_direct_predict(mv1.model, x),
              2: cs_direct_predict(mv2.model, x)}
    routed = {u: 2 if zlib.crc32(u.encode()) % 10000 / 10000.0 <
              Q_CANARY_WEIGHT else 1 for u in uris}
    rows = {v: [i for i, u in enumerate(uris) if routed[u] == v]
            for v in (1, 2)}
    checks = {f"v{v}": check_served_rows(
        f"int8 registry v{v}", {u: np.asarray(got[u]) for u in uris},
        [uris[i] for i in rows[v]], direct[v][rows[v]], CS_DIRECT_TOL)
        for v in (1, 2)}
    keys = sorted(serving.bucket_counts)
    if not any(k.endswith(":int8") for k in keys) or \
            not any(k.endswith(":f32") for k in keys):
        raise AssertionError(f"dispatch keys {keys}")
    recovered = ModelRegistry(root=root).recover(load=True)
    r2 = recovered._models["resnet50"][2]
    if r2.dtype != "int8" or not r2.model.model.calibrated or \
            not np.array_equal(r2.model.predict(x[:Q_PARITY_ROWS]),
                               direct[2][:Q_PARITY_ROWS]):
        raise AssertionError("recover did not reload v2 as the same int8 "
                             "model")
    del recovered, r2

    xp = x[:Q_PARITY_ROWS]
    with Int8Trace(clf.model) as card:
        card_rows = q.predict(xp)
    cpu = InferenceModel().load_quantized(directory, device="cpu")
    with Int8Trace(cpu.model.model) as host:
        cpu_rows = cpu.predict(xp)
    traces = compare_traces(card, host)
    errs = np.abs(card_rows - cpu_rows).max(1) / cpu_rows.max(1)
    if not np.array_equal(card_rows, direct[2][:Q_PARITY_ROWS]) or \
            (card_rows.argmax(1) != cpu_rows.argmax(1)).any() or \
            (errs > Q_RESNET_TOL).any():
        raise AssertionError(f"ResNet-50 int8 on the card against the "
                             f"CPU: {errs} of the rows' largest, {traces}")
    report = dict(
        model="ImageClassifier(1000, 'resnet-50')", calibrate_s=calibrate_s,
        kernels=len(q.model.kernels), chains=0, census=census,
        deploy_s=deploy_s, records=len(uris), routed_int8=len(rows[2]),
        routed_f32=len(rows[1]), rows=checks, dispatch_keys=keys,
        recovered_dtype="int8",
        cpu_rel_err=[float(e) for e in errs], cpu_tol=Q_RESNET_TOL,
        cpu_traces=traces,
        vs_f32=agreement(direct[2], direct[1]),
        param_bytes=q.model.param_bytes())
    del serving, registry, mv1, mv2, cpu
    return report, (f32, q, InferenceModel().load_keras_net(clf,
                                                            quantize=True))


def int8_op_group(evt):
    """A device kernel's group in the int8 and float forwards, by the
    outermost aten op that launched it: the integer GEMM, im2col and
    padding (the patch copy, its zero fill, SAME pads), pooling (its
    float16 widening is elementwise), cuDNN convolutions and float
    products of the float32 model, batch norm, layout copies, and the
    elementwise rest (the entry quantize, requantize, bias and scale
    epilogues, relu, residual adds, softmax)."""
    top, parent = evt, evt.cpu_parent
    while parent is not None:
        if parent.name.startswith("aten::"):
            top = parent
        parent = parent.cpu_parent
    name = top.name
    if name == "aten::_int_mm":
        return "integer GEMM (cuBLASLt)"
    if name in ("aten::copy_", "aten::zero_", "aten::zeros",
                "aten::pad", "aten::constant_pad_nd", "aten::fill_"):
        return "im2col and padding"
    if "max_pool" in name or "avg_pool" in name:
        return "pooling"
    if "conv" in name:
        return "convolution (cuDNN, float32)"
    if name in ("aten::matmul", "aten::mm", "aten::addmm", "aten::linear"):
        return "matmul (cuBLAS, float32)"
    if "batch_norm" in name:
        return "batch norm"
    if name in ("aten::contiguous", "aten::clone"):
        return "layout copies"
    return "requantize and elementwise"


def profile_forward(fn):
    """Device time by ``int8_op_group`` over one call of ``fn``, from
    ``torch.profiler`` (each kernel attributed to the CPU op that launched
    it), launches, and the device's idle share of the call's wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    groups, by = {}, "launching op"

    def add(group, ms, n):
        g = groups.setdefault(group, {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += ms
        g["launches"] += n

    for evt in prof.events():
        for k in getattr(evt, "kernels", ()):
            add(int8_op_group(evt), k.duration / 1e3, 1)
    if not groups:      # no kernel tied to its op: group by kernel name
        by = "kernel name"
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                add(conv_kernel_group(evt.key),
                    evt.self_device_time_total / 1e3, evt.count)
    busy_ms = sum(g["device_ms"] for g in groups.values())
    if busy_ms == 0.0:
        return dict(wall_ms=wall_us / 1e3, groups=None, idle_share=None)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_ms,
                grouped_by=by,
                launches=sum(g["launches"] for g in groups.values()),
                idle_share=1.0 - 1e3 * busy_ms / wall_us,
                groups=dict(sorted(groups.items(),
                                   key=lambda kv: -kv[1]["device_ms"])))


def time_int8(models, rs):
    """Float32, calibrated int8 and weight-only int8 (each kernel
    dequantized at every call) forwards of each model at each batch of
    Q_TIMED_BATCHES: records/s over Q_WINDOWS alternating windows of
    Q_WINDOW_BATCHES batches (inputs already on the card), then one
    profiled batch (device time by group, launches, idle share) and the
    peak memory of a batch."""
    runs = {(name, dtype, b): im for name, ims in models.items()
            for dtype, im in zip(("float32", "int8", "int8 weight-only"),
                                 ims)
            for b in Q_TIMED_BATCHES}
    inputs = {b: torch.from_numpy(rs.standard_normal(
        (b,) + RESNET_SHAPE).astype(np.float32)).cuda()
        for b in Q_TIMED_BATCHES}
    for (_, _, b), im in runs.items():        # warm every configuration
        im.predict_async(inputs[b])
    rates = {key: [] for key in runs}
    for _ in range(Q_WINDOWS):
        for key, im in runs.items():
            x = inputs[key[2]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(Q_WINDOW_BATCHES):
                im.predict_async(x)
            torch.cuda.synchronize()
            rates[key].append(Q_WINDOW_BATCHES * key[2] /
                              (time.perf_counter() - t0))
    out = []
    for key, im in runs.items():
        x = inputs[key[2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        im.predict_async(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_forward(lambda: im.predict_async(x))
        out.append(dict(model=key[0], dtype=key[1], batch=key[2],
                        records_per_s=rates[key],
                        records_per_s_median=float(np.median(rates[key])),
                        peak_memory_bytes=peak, profile=prof))
    return out


def int8_phase(seed, device, smi):
    """The int8 phase: bench_quant's models, VGG-16 (chained) and
    ResNet-50 (no chains, served through the registry) at full width, in
    float32 with TF32 off and in calibrated int8, weights from ``seed``;
    then the timed runs. The launch counts are set to 0 as it starts and
    read as it ends. Returns the report and K1-K5's launches."""
    shutil.rmtree(Q_ROOT, ignore_errors=True)
    os.makedirs(Q_ROOT)
    t0 = time.perf_counter()
    _kernels.LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rs = np.random.default_rng(seed + 60)
    bench = int8_bench_leg(seed + 61, rs)
    vgg, vgg_models = int8_vgg_leg(seed + 62, rs)
    resnet_report, resnet_models = int8_resnet_leg(seed + 63, rs, device)
    peak = torch.cuda.max_memory_allocated()
    timing = time_int8({"vgg-16": vgg_models, "resnet-50": resnet_models},
                       rs)
    launches = _kernels.LAUNCHES.snapshot()
    if launches:
        raise AssertionError(f"the int8 phase launched hand-written "
                             f"kernels {launches}")
    shutil.rmtree(Q_ROOT)
    return dict(card=smi, compute="float32 (TF32 off) and int8",
                bench_quant=bench, vgg16=vgg, resnet50=resnet_report,
                timing=timing, peak_memory_bytes=peak,
                k1_k5_launches=launches,
                clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu"),
                wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 14. the fleet: the zoo-serving CLI, the socket broker and shard fabric
# ---------------------------------------------------------------------------

# Cluster Serving's deployment of the cluster_serving phase (bench.py's
# ResNet-50, batch 16, buckets 1-16, top 5, float32 with TF32 off) served
# from worker processes through the port's CLI: Leg A, the daemon on the
# file transport (start, restart, stop); Leg B, a fleet of 2 over one
# socket broker (a clean window, then a SIGKILL of worker 1 and its
# redelivery; then the same fleet with the echo stub for the transport's
# ceiling); Leg C, a fleet of 2 over 2 broker processes (shard://).
FL_REPO = os.path.dirname(os.path.abspath(__file__))
FL_ROOT = os.path.join(FL_REPO, "build", "chip_smoke_fleet")
# records: depth, halved in PR 18 to keep the script inside its limit
# beside the parallel phase's legs D-G; leg B's clean window and ceiling
# halved again in PR 21 beside the text phase (leg B is the slowest leg,
# ``leg_seconds``)
FL_A_RECORDS, FL_A_AFTER_RESTART = 64, 16
FL_B_CLEAN, FL_B_RECORDS, FL_B_KILL_AFTER = 64, 128, 32
FL_CEILING_RECORDS = 128
FL_C_RECORDS = 64
FL_WORKERS = 2
# client processes of the timed socket windows (one client alone writes
# 602 KB records slower than two workers serve them); Leg A's file
# transport and the kill run have one
FL_CLIENTS = 4
# one wait for a process to come up, or for a client's results
FL_TIMEOUT_S = 240.0
# the echo stub's row is the mean of the record's floats, the same numpy
# float32 reduction in the worker and here
FL_ECHO_TOL = 1e-6
FL_CONFIG = """\
model:
{model}
data:
  src: {src}
  image_shape: 3, 224, 224
params:
  batch_size: 16
  top_n: {top_n}
  warmup: {warmup}
  workers: {workers}
  min_workers: {workers}
  max_workers: {workers}
  health_interval: 0.25
  health_timeout: 30
"""


def fl_config(workdir, src, model_dir=None):
    """Write ``workdir``'s config.yaml: the saved ResNet-50, or (no
    ``model_dir``) the echo stub at 0 ms a batch with raw output."""
    os.makedirs(workdir, exist_ok=True)
    model = (f"  path: {model_dir}" if model_dir else
             "  stub_ms_per_batch: 0")
    with open(os.path.join(workdir, "config.yaml"), "w") as f:
        f.write(FL_CONFIG.format(model=model, src=src,
                                 top_n=5 if model_dir else 0,
                                 warmup="true" if model_dir else "false",
                                 workers=FL_WORKERS))


def fl_env():
    """The environment of every process the phase starts: the checkout on
    PYTHONPATH, no ZOO_ override, and TF32 off in cuBLAS and cuDNN (as
    this process has it through torch.backends)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ZOO_")}
    env["PYTHONPATH"] = FL_REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["NVIDIA_TF32_OVERRIDE"] = "0"
    return env


def fl_tail(path, n=3000):
    try:
        with open(path, errors="replace") as f:
            return f"\n--- {path} ---\n" + f.read()[-n:]
    except OSError:
        return f"\n--- {path}: none ---"


def fl_cli(workdir, *args, timeout=180):
    """One CLI call in a process of its own (``start`` and ``restart``
    fork a daemon, which must not inherit this process's CUDA context)."""
    return subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli", *args,
         "--dir", workdir], capture_output=True, text=True, timeout=timeout,
        env=fl_env(), cwd=FL_REPO)


def fl_main(workdir, *args):
    """One CLI call in this process, for the verbs that touch no device:
    (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = zoo_cli.main([*args, "--dir", workdir])
    return rc, buf.getvalue()


def fl_expect(what, rc, want, out):
    if rc != want:
        raise AssertionError(f"fleet: {what} returned {rc}, expected "
                             f"{want}:\n{out}")


def fl_spawn(procs, workdir, log, *args):
    """A long-running CLI verb (broker, fleet) with its output in ``log``."""
    with open(log, "ab") as f:
        p = subprocess.Popen(
            [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli",
             *args, "--dir", workdir], stdout=f, stderr=subprocess.STDOUT,
            env=fl_env(), cwd=FL_REPO)
    procs.append(p)
    return p


def fl_stop(p, timeout=60.0):
    """SIGTERM (a fleet drains and stops its workers), then SIGKILL."""
    if p.poll() is None:
        p.terminate()
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def fl_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def fl_free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def fl_images(seed, n):
    rng = np.random.default_rng(seed + 14)
    return rng.standard_normal((n,) + RESNET_SHAPE).astype(np.float32)


def fl_client(spec, seed, first, n, prefix, go, results):
    """A client process: ``n`` tensor records (images ``first`` on) into
    the transport ``spec`` as fast as it can once ``go`` is set, then
    every result; puts {"ready"} when prepared, then {"rows": {uri:
    (value, type)}, "t0", "t_written", "t_done"} (or {"error"})."""
    from analytics_zoo_tpu_torch.serving.client import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.queue_backend import \
        get_queue_backend
    try:
        x = fl_images(seed, first + n)[first:]
        q = get_queue_backend(spec)
        iq, oq = InputQueue(backend=q), OutputQueue(backend=q)
        uris = [f"{prefix}-{first + i}" for i in range(n)]
        results.put({"ready": True})
        if not go.wait(FL_TIMEOUT_S):
            raise RuntimeError("never told to start")
        t0 = time.time()
        for uri, row in zip(uris, x):
            iq.enqueue(uri, t=row)
        t_written = time.time()
        got = oq.wait_all(uris, timeout=FL_TIMEOUT_S, poll=0.005,
                          max_poll=0.05)
        t_done = time.time()
        results.put({"rows": {u: (np.asarray(r), type(r).__name__)
                              for u, r in got.items()},
                     "t0": t0, "t_written": t_written, "t_done": t_done})
    except Exception:  # noqa: BLE001 - reported to the parent
        import traceback
        results.put({"error": traceback.format_exc()})


def fl_run_client(spec, seed, first, n, prefix, clients=1,
                  while_waiting=None):
    """Images ``first`` to ``first + n`` from ``clients`` spawned client
    processes (contiguous shares), started together once all are
    prepared; ``while_waiting()`` is polled until every reply is in.
    Returns {"rows", "uris", "write_s", "wall_s", "clients"} from the
    first enqueue; raises on a client error or a missing uri. Clients of
    a ``file:`` transport pop each other's results: give it one."""
    ctx = multiprocessing.get_context("spawn")
    results, go = ctx.Queue(), ctx.Event()
    cut = np.linspace(first, first + n, clients + 1).astype(int)
    procs = [ctx.Process(target=fl_client,
                         args=(spec, seed, int(a), int(b - a), prefix, go,
                               results))
             for a, b in zip(cut[:-1], cut[1:])]
    for proc in procs:
        proc.start()
    replies, ready = [], 0
    try:
        deadline = time.time() + 2 * FL_TIMEOUT_S
        while len(replies) < clients:
            try:
                msg = results.get(timeout=0.01)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if time.time() > deadline or dead:
                    raise AssertionError(f"fleet client {prefix}: "
                                         f"{len(replies)} of {clients} "
                                         f"replies (exits {dead})")
                if go.is_set() and while_waiting is not None:
                    while_waiting()
                continue
            if "error" in msg:
                raise AssertionError(f"fleet client {prefix}: "
                                     f"{msg['error']}")
            if msg.get("ready"):
                ready += 1
                if ready == clients:
                    go.set()
            else:
                replies.append(msg)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
    rows = {u: v for r in replies for u, v in r["rows"].items()}
    want = [f"{prefix}-{first + i}" for i in range(n)]
    if sorted(rows) != sorted(want):
        missing = sorted(set(want) - set(rows))
        raise AssertionError(f"fleet client {prefix}: {len(rows)} of {n} "
                             f"results, missing {missing[:5]}")
    t0 = min(r["t0"] for r in replies)
    return dict(rows=rows, uris=want, clients=clients,
                write_s=max(r["t_written"] for r in replies) - t0,
                wall_s=max(r["t_done"] for r in replies) - t0)


def fl_check_rows(name, reply, direct, first):
    """Every row a top-5 ServingResult within CS_DIRECT_TOL of the card's
    direct predict of its image."""
    rows = reply["rows"]
    if any(kind != "ServingResult" or v.shape != (5, 2)
           for v, kind in rows.values()):
        raise AssertionError(f"{name}: a result is not a top-5 row")
    uris = reply["uris"]
    return check_served_rows(name, {u: rows[u][0] for u in uris}, uris,
                             direct[first:first + len(uris)], CS_DIRECT_TOL)


def fl_spawned_at(pid):
    """The epoch second at which process ``pid`` started (/proc)."""
    with open(f"/proc/{pid}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        boot = time.time() - float(f.read().split()[0])
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def fl_wait_workers(workdir, fleet, log, not_pids=()):
    """Block until every worker has a heartbeat from a pid not in
    ``not_pids``; {wid: (pid, seconds from spawn to first heartbeat)}."""
    deadline = time.time() + FL_TIMEOUT_S
    while time.time() < deadline:
        if fleet.poll() is not None:
            raise AssertionError(f"fleet: the fleet exited rc "
                                 f"{fleet.returncode}" + fl_tail(log))
        hs = [read_health(workdir, w) for w in range(FL_WORKERS)]
        if all(h and h.get("pid") and h["pid"] not in not_pids
               for h in hs):
            return {w: (h["pid"], h["started_at"] -
                        fl_spawned_at(h["pid"])) for w, h in enumerate(hs)}
        time.sleep(0.05)
    raise AssertionError("fleet: workers not up" + fl_tail(log))


def fl_compute_apps():
    """nvidia-smi's compute apps: [(pid, used_memory)], one a CUDA
    context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return [(int(pid), mem.strip()) for pid, mem in
            (line.split(",", 1) for line in out.strip().splitlines())]


def fl_on_card(what, baseline, pids):
    """Each process of ``pids`` holds a context on the card: nvidia-smi
    lists one compute app more for each than ``baseline`` (its list
    before they started). A sandbox's nvidia-smi may not see the pids of
    its processes (it lists them as 1), so the count is held, and any
    listed pid that is not one of this sandbox's must be a worker's.
    Returns the list."""
    ours = set(pids) | {os.getpid()} | {p for p, _ in baseline}
    deadline = time.time() + 30.0
    while True:
        apps = fl_compute_apps()
        if len(apps) == len(baseline) + len(pids):
            break
        if time.time() > deadline:
            raise AssertionError(f"fleet: {what}: {len(apps)} compute "
                                 f"apps on the card, expected "
                                 f"{len(baseline)} + {len(pids)}: {apps}")
        time.sleep(0.2)
    stray = [p for p, _ in apps if p not in ours and p != 1]
    if stray:
        raise AssertionError(f"fleet: {what}: compute apps {stray} are not "
                             f"the workers {sorted(pids)}: {apps}")
    return dict(pids=sorted(pids), apps=[[p, m] for p, m in apps],
                baseline=[[p, m] for p, m in baseline])


def fl_broker_stats(port):
    q = SocketStreamQueue("127.0.0.1", port, connect_timeout=5.0)
    try:
        return q.stats()
    finally:
        q.close()


def fl_exactly_once(name, before, after, n, ports):
    """Broker counters over a run of ``n`` records (summed over ``ports``):
    each enqueued, delivered and acked once (a redelivery adds one
    delivery), and nothing left queued, claimed or pending."""
    d = {k: sum(after[p][k] - before[p][k] for p in ports)
         for k in ("enqueued", "delivered", "redelivered", "acked")}
    left = {k: sum(after[p][k] for p in ports)
            for k in ("stream_len", "claims_outstanding",
                      "results_pending")}
    if d["enqueued"] != n or d["acked"] != n or \
            d["delivered"] != n + d["redelivered"] or any(left.values()):
        raise AssertionError(f"{name}: broker counters {d}, left {left}, "
                             f"for {n} records")
    return dict(d, **left)


def fl_leg_a(seed, model_dir, direct, cpu_probs, daemons):
    """Leg A: init, status, start, a client's records, status, restart,
    more records, stop and shutdown, on the file transport."""
    wd = os.path.join(FL_ROOT, "serving")
    spec = "file:" + os.path.join(FL_ROOT, "stream_a")
    rc, out = fl_main(wd, "init")
    fl_expect("init", rc, 0, out)
    rc, out = fl_main(wd, "init")
    fl_expect("a second init", rc, 1, out)
    fl_config(wd, spec, model_dir)
    rc, out = fl_main(wd, "status")
    fl_expect("status while stopped", rc, 3, out)
    log = os.path.join(wd, zoo_cli.LOGFILE)
    pidfile = os.path.join(wd, zoo_cli.PIDFILE)
    warm_line = f"warmup: {len(CS_BUCKETS)}/{len(CS_BUCKETS)} buckets"

    def start(verb):
        t0 = time.time()
        daemons.append(wd)
        res = fl_cli(wd, verb, "--device", "cuda")
        fl_expect(verb, res.returncode, 0, res.stdout + res.stderr)
        want = 1 if verb == "start" else 2
        while time.time() - t0 < FL_TIMEOUT_S:
            try:
                with open(log) as f:
                    text = f.read()
            except OSError:
                text = ""
            if text.count(warm_line) >= want:
                return time.time() - t0, zoo_cli._read_pid(pidfile)
            if "Traceback" in text:
                break
            time.sleep(0.1)
        raise AssertionError(f"fleet: the daemon did not warm up after "
                             f"{verb}" + fl_tail(log))

    baseline = fl_compute_apps()
    start_s, pid = start("start")
    res = fl_cli(wd, "start", "--device", "cuda")
    fl_expect("a second start", res.returncode, 1, res.stdout + res.stderr)
    apps = fl_on_card("the daemon", baseline, [pid])
    reply = fl_run_client(spec, seed, 0, FL_A_RECORDS, "a")
    rows = fl_check_rows("fleet leg A against the direct predict", reply,
                         direct, 0)
    cpu = check_served_rows(
        "fleet leg A against the CPU",
        {u: reply["rows"][u][0] for u in reply["uris"]},
        reply["uris"][:CS_CPU_ROWS], cpu_probs, CS_CPU_TOL)
    stats, deadline = {}, time.time() + 30
    while time.time() < deadline and \
            stats.get("results_out") != FL_A_RECORDS:
        try:
            with open(os.path.join(wd, zoo_cli.STATSFILE)) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    if stats.get("records_in") != FL_A_RECORDS or \
            stats.get("results_out") != FL_A_RECORDS or \
            stats.get("dropped") or stats.get("dead_letters") or \
            stats.get("shed") or stats["queue"]["duplicates"]:
        raise AssertionError(f"fleet leg A: the daemon's stats {stats}")
    rc, status = fl_main(wd, "status")
    fl_expect("status while serving", rc, 0, status)
    if f"running (pid {pid})" not in status or \
            f"records_in={FL_A_RECORDS}" not in status:
        raise AssertionError(f"fleet leg A: status printed\n{status}")
    restart_s, pid2 = start("restart")
    if pid2 in (None, pid):
        raise AssertionError(f"fleet leg A: restart left pid {pid2}")
    reply2 = fl_run_client(spec, seed, FL_A_RECORDS, FL_A_AFTER_RESTART,
                           "a")
    rows2 = fl_check_rows("fleet leg A after the restart", reply2, direct,
                          FL_A_RECORDS)
    for verb in ("stop", "shutdown"):
        rc, out = fl_main(wd, verb)
        fl_expect(verb, rc, 0, out)
    rc, out = fl_main(wd, "status")
    fl_expect("status after shutdown", rc, 3, out)
    if os.path.exists(pidfile) or os.path.exists(log):
        raise AssertionError("fleet leg A: the pidfile or log is left")
    daemons.clear()
    return dict(transport=spec, records=FL_A_RECORDS,
                after_restart=FL_A_AFTER_RESTART,
                start_to_warm_s=start_s, restart_to_warm_s=restart_s,
                daemon_pids=[pid, pid2], compute_apps=apps,
                records_per_s=FL_A_RECORDS / reply["wall_s"],
                client_write_s=reply["write_s"],
                client_wall_s=reply["wall_s"], direct=rows, cpu=cpu,
                after_restart_rows=rows2,
                daemon_stats=dict(records_in=stats["records_in"],
                                  results_out=stats["results_out"],
                                  buckets=stats.get("buckets")),
                status=status)


def fl_leg_b(seed, model_dir, direct, port, procs, worker_pids):
    """Leg B: a broker and a fleet of 2 through the CLI; a clean window;
    a run with worker 1 SIGKILLed; then the echo-stub fleet on the same
    broker for the transport's ceiling."""
    spec = f"socket://127.0.0.1:{port}"
    wd = os.path.join(FL_ROOT, "fleet_b")
    fl_config(wd, spec, model_dir)
    broker = fl_spawn(procs, wd, os.path.join(FL_ROOT, "broker_b.log"),
                      "broker", "--transport", spec)
    wait_broker_up("127.0.0.1", port, timeout=60.0)
    log = os.path.join(FL_ROOT, "fleet_b.log")
    baseline = fl_compute_apps()
    fleet = fl_spawn(procs, wd, log, "fleet", "--workers", str(FL_WORKERS),
                     "--transport", spec, "--device", "cuda")
    up = fl_wait_workers(wd, fleet, log)
    worker_pids.update(pid for pid, _ in up.values())
    apps = fl_on_card("the socket fleet", baseline,
                      [pid for pid, _ in up.values()])
    before = {port: fl_broker_stats(port)}
    clean = fl_run_client(spec, seed, 0, FL_B_CLEAN, "b-clean",
                          clients=FL_CLIENTS)
    counts_clean = fl_exactly_once("fleet leg B's clean window", before,
                                   {port: fl_broker_stats(port)},
                                   FL_B_CLEAN, [port])
    rows_clean = fl_check_rows("fleet leg B's clean window", clean, direct,
                               0)

    # the kill: worker 1 exists (its heartbeat is on disk) and the band
    # (min = max = 2) cannot retire it; SIGKILL once 32 results are back
    victim = read_health(wd, 1)
    if not victim or not victim.get("pid"):
        raise AssertionError("fleet leg B: no heartbeat for worker 1")
    before = {port: fl_broker_stats(port)}
    kill = {}

    def maybe_kill():
        if kill:
            return
        st = fl_broker_stats(port)
        acked = st["acked"] - before[port]["acked"]
        if acked >= FL_B_KILL_AFTER:
            os.kill(int(victim["pid"]), signal.SIGKILL)
            kill.update(t=time.time(), acked=acked,
                        claims_outstanding=st["claims_outstanding"])

    reply = fl_run_client(spec, seed, 0, FL_B_RECORDS, "b",
                          while_waiting=maybe_kill)
    if not kill:
        raise AssertionError("fleet leg B: the run ended before the kill")
    time.sleep(1.0)             # a late duplicate would land now
    after = {port: fl_broker_stats(port)}
    counts = fl_exactly_once("fleet leg B with the SIGKILL", before, after,
                             FL_B_RECORDS, [port])
    if counts["redelivered"] <= 0:
        raise AssertionError(f"fleet leg B: nothing redelivered after the "
                             f"kill {kill}: {counts}")
    rows = fl_check_rows("fleet leg B with the SIGKILL", reply, direct, 0)
    restarted = fl_wait_workers(wd, fleet, log, not_pids={victim["pid"]})
    if restarted[0][0] != up[0][0]:
        raise AssertionError(f"fleet leg B: worker 0 changed {restarted}")
    new_pid, restart_s = restarted[1]
    worker_pids.add(new_pid)
    rc, status = fl_main(wd, "status")
    fl_expect("the fleet's status", rc, 0, status)
    if "worker 1:" not in status or "restarts=1" not in status or \
            f"transport {spec}:" not in status or \
            f"redelivered={after[port]['redelivered']}" not in status:
        raise AssertionError(f"fleet leg B: status printed\n{status}")
    apps_after = fl_on_card("the socket fleet after the restart", baseline,
                            [up[0][0], new_pid])
    fl_stop(fleet)
    leg = dict(transport=spec, clean_records=FL_B_CLEAN,
               records=FL_B_RECORDS, kill_after=FL_B_KILL_AFTER,
               worker_start_s={w: s for w, (_, s) in up.items()},
               restarted_worker_start_s=restart_s,
               kill=kill,
               victim_pid=victim["pid"], new_pid=new_pid,
               compute_apps=apps, compute_apps_after_restart=apps_after,
               clients=FL_CLIENTS,
               clean_records_per_s=FL_B_CLEAN / clean["wall_s"],
               clean_client_write_s=clean["write_s"],
               clean_client_wall_s=clean["wall_s"],
               kill_run_wall_s=reply["wall_s"], broker_clean=counts_clean,
               broker=counts, direct_clean=rows_clean, direct=rows,
               status=status)

    # the socket transport's ceiling: the same fleet, broker and records
    # with the echo stub (0 ms a batch, raw output)
    wd_s = os.path.join(FL_ROOT, "fleet_stub")
    fl_config(wd_s, spec)
    log_s = os.path.join(FL_ROOT, "fleet_stub.log")
    stub = fl_spawn(procs, wd_s, log_s, "fleet", "--workers",
                    str(FL_WORKERS), "--transport", spec, "--device", "cuda")
    up_s = fl_wait_workers(wd_s, stub, log_s)
    worker_pids.update(pid for pid, _ in up_s.values())
    before = {port: fl_broker_stats(port)}
    ceiling = fl_run_client(spec, seed, 0, FL_CEILING_RECORDS, "s",
                            clients=FL_CLIENTS)
    counts_s = fl_exactly_once("the socket ceiling", before,
                               {port: fl_broker_stats(port)},
                               FL_CEILING_RECORDS, [port])
    x = fl_images(seed, FL_CEILING_RECORDS)
    means = x.reshape(len(x), -1).mean(axis=1)
    worst = max(abs(float(ceiling["rows"][u][0].ravel()[0]) -
                    float(means[i]))
                for i, u in enumerate(ceiling["uris"]))
    if worst > FL_ECHO_TOL:
        raise AssertionError(f"the socket ceiling: echo rows {worst} off")
    fl_stop(stub)
    fl_stop(broker)
    record_bytes = int(np.prod(RESNET_SHAPE)) * 4
    ceiling_leg = dict(
        transport=spec, model="echo stub, 0 ms a batch",
        clients=FL_CLIENTS,
        records=FL_CEILING_RECORDS, record_bytes=record_bytes,
        records_per_s=FL_CEILING_RECORDS / ceiling["wall_s"],
        mb_per_s=FL_CEILING_RECORDS * record_bytes / ceiling["wall_s"] / 1e6,
        client_write_s=ceiling["write_s"], client_wall_s=ceiling["wall_s"],
        worker_start_s={w: s for w, (_, s) in up_s.items()},
        broker=counts_s, echo_max_abs_err=worst, echo_tol=FL_ECHO_TOL)
    return leg, ceiling_leg


def fl_leg_c(seed, model_dir, direct, ports, procs, worker_pids):
    """Leg C: two broker processes, a fleet of 2 over their shard:// spec,
    128 records, a status row for each shard."""
    spec = "shard://" + ",".join(f"127.0.0.1:{p}" for p in ports)
    wd = os.path.join(FL_ROOT, "fleet_c")
    fl_config(wd, spec, model_dir)
    brokers = [fl_spawn(procs, wd, os.path.join(FL_ROOT, f"broker_{p}.log"),
                        "broker", "--transport", f"socket://127.0.0.1:{p}")
               for p in ports]
    for p in ports:
        wait_broker_up("127.0.0.1", p, timeout=60.0)
    log = os.path.join(FL_ROOT, "fleet_c.log")
    baseline = fl_compute_apps()
    fleet = fl_spawn(procs, wd, log, "fleet", "--workers", str(FL_WORKERS),
                     "--transport", spec, "--device", "cuda")
    up = fl_wait_workers(wd, fleet, log)
    worker_pids.update(pid for pid, _ in up.values())
    before = {p: fl_broker_stats(p) for p in ports}
    reply = fl_run_client(spec, seed, 0, FL_C_RECORDS, "c",
                          clients=FL_CLIENTS)
    after = {p: fl_broker_stats(p) for p in ports}
    counts = fl_exactly_once("fleet leg C", before, after, FL_C_RECORDS,
                             ports)
    per_shard = {p: after[p]["enqueued"] - before[p]["enqueued"]
                 for p in ports}
    if min(per_shard.values()) <= 0:
        raise AssertionError(f"fleet leg C: a shard carried nothing "
                             f"{per_shard}")
    rows = fl_check_rows("fleet leg C", reply, direct, 0)
    rc, status = fl_main(wd, "status")
    fl_expect("the shard fleet's status", rc, 0, status)
    shard_rows = [ln for ln in status.splitlines()
                  if ln.strip().startswith("shard socket://127.0.0.1:")
                  and "health=up" in ln]
    if f"transport {spec}: healthy=2/2" not in status or \
            len(shard_rows) != len(ports):
        raise AssertionError(f"fleet leg C: status printed\n{status}")
    apps = fl_on_card("the shard fleet", baseline,
                      [pid for pid, _ in up.values()])
    fl_stop(fleet)
    for b in brokers:
        fl_stop(b)
    return dict(transport=spec, records=FL_C_RECORDS, clients=FL_CLIENTS,
                records_per_shard=per_shard,
                records_per_s=FL_C_RECORDS / reply["wall_s"],
                worker_start_s={w: s for w, (_, s) in up.items()},
                compute_apps=apps, broker=counts, direct=rows,
                status=status)


def fleet_phase(seed, device, smi):
    """The fleet phase (14 in the module docstring). Returns its report and
    K1-K5's launches in this process over the phase (none)."""
    shutil.rmtree(FL_ROOT, ignore_errors=True)
    os.makedirs(FL_ROOT)
    _kernels.LAUNCHES.reset()
    t_phase = time.perf_counter()
    procs, worker_pids, daemons = [], set(), []
    report = dict(card=smi, workers=FL_WORKERS,
                  config=FL_CONFIG.format(model="  path: <resnet50>",
                                          src="<per leg>", top_n=5,
                                          warmup="true",
                                          workers=FL_WORKERS))
    try:
        # the model, and its direct predict on the card and the CPU's
        model_dir = os.path.join(FL_ROOT, "resnet50")
        clf = build_resnet(seed)
        clf.save_model(model_dir)
        del clf
        im = InferenceModel().load(model_dir)
        if im.model.device != device:
            raise AssertionError(f"InferenceModel.load put it on "
                                 f"{im.model.device}")
        x = fl_images(seed, FL_B_RECORDS)
        direct = cs_direct_predict(im, x)
        cpu_model = SPMDTrainer(resnet_twin(im.model.model),
                                get_loss("sparse_categorical_crossentropy"),
                                get_optimizer("sgd"), device="cpu")
        cpu_probs = cpu_model.predict(x[:CS_CPU_ROWS], CS_CPU_ROWS)
        del cpu_model, im
        collect()
        seconds = report["leg_seconds"] = {
            "setup": time.perf_counter() - t_phase}

        report["leg_a"] = fl_leg_a(seed, model_dir, direct, cpu_probs,
                                   daemons)
        seconds["a"] = time.perf_counter() - t_phase - sum(seconds.values())
        emit("fleet", check="leg A: the CLI daemon on file:", ok=True,
             **report["leg_a"])
        port_b, *ports_c = fl_free_ports(3)
        report["leg_b"], report["ceiling"] = fl_leg_b(
            seed, model_dir, direct, port_b, procs, worker_pids)
        seconds["b"] = time.perf_counter() - t_phase - sum(seconds.values())
        emit("fleet", check="leg B: a fleet of 2 over socket://", ok=True,
             **report["leg_b"])
        emit("fleet", check="the socket transport's ceiling", ok=True,
             **report["ceiling"])
        report["leg_c"] = fl_leg_c(seed, model_dir, direct, ports_c, procs,
                                   worker_pids)
        seconds["c"] = time.perf_counter() - t_phase - sum(seconds.values())
        emit("fleet", check="leg C: a fleet of 2 over shard://", ok=True,
             **report["leg_c"])
        alive = sorted(p for p in worker_pids if fl_alive(p))
        if alive:
            raise AssertionError(f"fleet: workers {alive} outlived their "
                                 f"fleets")
    finally:
        for p in procs:
            fl_stop(p, timeout=30.0)
        for wd in daemons:
            fl_main(wd, "stop")
        for pid in worker_pids:
            if fl_alive(pid):
                os.kill(pid, signal.SIGKILL)
        shutil.rmtree(FL_ROOT, ignore_errors=True)
    report["launches"] = no_launches("the fleet phase")
    report["wall_s"] = time.perf_counter() - t_phase
    return report, report["launches"]


# ---------------------------------------------------------------------------
# 15. observe: the health monitor, the memory accountant, MFU, the profiler
# hook, train_cli and trace_merge on the bf16 classifier
# ---------------------------------------------------------------------------

# the monitored run: 16 steps at TRAIN_BATCH x 512 (one epoch of 16
# distinct batches), a window every 4 steps, the profiler over steps 5-6
OBS_STEPS, OBS_LOG_EVERY = 16, 4
OBS_PROFILE_START, OBS_PROFILE_STEPS = 4, 2
# the drill: 8 batches an epoch, a checkpoint every 4 steps, step:nan@6
# with health_halt (halted at the window of step 8: latest stays ckpt-4),
# then grad:nan@3 without halt
OBS_DRILL_BATCHES, OBS_NAN_AT, OBS_GRAD_NAN_AT = 8, 6, 3
# the card's memory share at which the watermark leg's poll latches a dump
OBS_WATERMARK = 0.01
# the timing leg: the monitor and accountant off and on in alternating
# windows of one epoch of OBS_DRILL_BATCHES steps each
OBS_TIMED_PAIRS = 2
# the FLOP count against bench.py's formula, and MFU against that count
# over the StepTimeMs scalar over the card's peak
OBS_FLOPS_TOL, OBS_MFU_TOL = 0.01, 0.05
OBS_TAGS = ("Loss", "LearningRate", "Throughput", "StepTimeMs",
            "HealthState", "HBMTotalMB", "HBMParamsMB", "HBMOptStateMB",
            "HBMActivationsMB", "HBMTransfersMB", "InfeedWaitMs",
            "InputBoundFraction", "MFU")
OBS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_observe")


def bert_flops_per_step(batch, seq, hidden, blocks, n_classes):
    """bench.py's ``_bert_flops_per_step`` (bench.py:357-367), copied:
    matmul FLOPs of one forward and backward step (backward twice the
    forward)."""
    tokens = batch * seq
    dense = 2 * hidden * (3 * hidden + hidden + 8 * hidden)
    attn_flops = 4 * seq * hidden
    fwd = tokens * blocks * (dense + attn_flops)
    fwd += batch * 2 * hidden * hidden
    fwd += batch * 2 * hidden * n_classes
    return 3 * fwd


def obs_files(directory, prefix):
    try:
        return sorted(f for f in os.listdir(directory)
                      if f.startswith(prefix))
    except FileNotFoundError:
        return []


def obs_summary(model):
    """{tag: [(step, value)]} of the model's TrainSummary."""
    out = {}
    for step, _, tag, value in model.get_train_summary():
        out.setdefault(tag, []).append((int(step), float(value)))
    return out


def obs_monitored_run(seed, dirs, smi):
    """Leg A: the monitored ``fit``; returns the model, its report and
    the launches of the run."""
    model = ckpt_model(seed)
    model.set_tensorboard(dirs["logs"], "observe")
    x, y, _ = train_data(seed, OBS_STEPS * TRAIN_BATCH, ids=np.int32)
    torch.cuda.synchronize()
    # the script's own window of the allocator's peak: the accountant
    # reads that counter and never resets it
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0_us = time.time() * 1e6
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1_us = time.time() * 1e6
    launches = _kernels.LAUNCHES.snapshot()
    peak_alloc = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    trainer = model.trainer
    n_block = CKPT_BLOCKS
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    want = {k: OBS_STEPS * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"observe: launches {launches}, expected {want}")
    losses = list(trainer.step_losses)
    if len(losses) != OBS_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"observe: losses {losses}")

    # every scalar at every window, the health state 0 throughout
    scalars = obs_summary(model)
    steps = list(range(OBS_LOG_EVERY, OBS_STEPS + 1, OBS_LOG_EVERY))
    for tag in OBS_TAGS:
        got = [s for s, _ in scalars.get(tag, [])]
        if got != steps:
            raise AssertionError(f"observe: {tag} at steps {got}, "
                                 f"expected {steps}")
        if not all(np.isfinite(v) for _, v in scalars[tag]):
            raise AssertionError(f"observe: {tag} {scalars[tag]}")
    if any(v != 0.0 for _, v in scalars["HealthState"]):
        raise AssertionError(f"observe: HealthState {scalars['HealthState']}")

    # the memory breakdown: parameters and Adam's leaves exactly
    bd = trainer.hbm_breakdown
    if bd is None:
        raise AssertionError("observe: no memory breakdown")
    mib = 1.0 / 2 ** 20
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("observe: a parameter is not float32")
    leaves = optimizer_leaves(trainer.opt_state, param_order(model))
    adam_bytes = sum(l.numel() * l.element_size() if torch.is_tensor(l)
                     else np.asarray(l).nbytes for l in leaves)
    if bd["params_bytes"] != param_bytes or \
            any(v != np.float32(param_bytes * mib)
                for _, v in scalars["HBMParamsMB"]):
        raise AssertionError(f"observe: params {bd['params_bytes']} bytes "
                             f"/ {scalars['HBMParamsMB']} MB against "
                             f"{param_bytes}")
    if bd["opt_state_bytes"] != adam_bytes or \
            any(v != np.float32(adam_bytes * mib)
                for _, v in scalars["HBMOptStateMB"]):
        raise AssertionError(f"observe: optimizer state "
                             f"{bd['opt_state_bytes']} bytes against "
                             f"Adam's leaves' {adam_bytes}")
    # saved activations (saved-tensor hooks) <= the first step's peak
    # above what was allocated before it (the allocator); that step's
    # whole peak <= the fit's, read by the script, <= the reserved
    # segments (a second counter of the allocator's)
    saved, step_peak = bd["activations_temp_bytes"], bd["step_peak_bytes"]
    if step_peak is None or not 0 < saved <= step_peak or \
            not bd["total_bytes"] <= peak_alloc <= reserved:
        raise AssertionError(f"observe: saved activations {saved}, the "
                             f"allocator's step peak {step_peak}, the "
                             f"step's total {bd['total_bytes']}, the fit's "
                             f"max allocated {peak_alloc}, reserved "
                             f"{reserved}")

    # FLOPs and MFU
    want_flops = bert_flops_per_step(TRAIN_BATCH, BERT_CONFIG["seq_len"],
                                     BERT_CONFIG["hidden_size"], n_block,
                                     N_CLASSES)
    flops = trainer.flops_per_step
    if not flops or abs(flops - want_flops) > OBS_FLOPS_TOL * want_flops:
        raise AssertionError(f"observe: {flops} FLOPs a step counted, "
                             f"bench.py's formula {want_flops}")
    peak = profiling.peak_flops(torch.cuda.get_device_name(0))
    if not peak:
        raise AssertionError("observe: no peak FLOP/s for "
                             f"{torch.cuda.get_device_name(0)}")
    step_ms = dict(scalars["StepTimeMs"])
    mfu_err = 0.0
    for s, v in scalars["MFU"]:
        want_mfu = flops / (step_ms[s] * 1e-3) / peak
        mfu_err = max(mfu_err, abs(v - want_mfu) / want_mfu)
    if mfu_err > OBS_MFU_TOL:
        raise AssertionError(f"observe: MFU {scalars['MFU']} against "
                             f"{flops} FLOPs over {step_ms} ms")

    # the profiler's trace names the flash kernels' symbols
    traces = obs_files(dirs["profile"], "trace-torch-profiler-")
    if len(traces) != 1:
        raise AssertionError(f"observe: profiler traces {traces}")
    with open(os.path.join(dirs["profile"], traces[0])) as f:
        prof_text = f.read()
    for sym in TENSOR_CORE_KERNELS:
        if sym not in prof_text:
            raise AssertionError(f"observe: {sym} not in the profiler trace")

    # the trainer's trace merged with the profiler's: 16 train/step spans
    telemetry.write_trace()
    merged_path = os.path.join(dirs["trace"], "merged.json")
    out = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.utils.trace_merge",
         "merge", "--dir", dirs["trace"], "--extra", dirs["profile"], "-o",
         merged_path], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"observe: trace_merge exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    with open(merged_path) as f:
        merged = json.load(f)["traceEvents"]
    step_spans = [e for e in merged if e.get("name") == "train/step"
                  and e.get("ph") == "B" and e.get("pid") == os.getpid()
                  and t0_us <= e.get("ts", 0) <= t1_us]
    kernel_events = sum(1 for e in merged
                        if TENSOR_CORE_KERNELS[0] in str(e.get("name", "")))
    if len(step_spans) != OBS_STEPS or not kernel_events:
        raise AssertionError(f"observe: the merged trace holds "
                             f"{len(step_spans)} train/step spans and "
                             f"{kernel_events} {TENSOR_CORE_KERNELS[0]} "
                             f"events")

    # train_cli over the log and trace dirs
    logdir = os.path.join(dirs["logs"], "observe")
    cli = [sys.executable, "-m", "analytics_zoo_tpu_torch.pipeline.train_cli"]
    out = subprocess.run(cli + ["summary", "--logdir", logdir, "--trace-dir",
                                dirs["trace"]],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"observe: train_cli summary exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    cli_summary = json.loads(out.stdout)
    missing = [t for t in OBS_TAGS if t not in cli_summary["scalars"]]
    if missing or "zoo_train_health_state" not in cli_summary["gauges"]:
        raise AssertionError(f"observe: train_cli summary lacks {missing} "
                             f"or the health gauge")
    out = subprocess.run(cli + ["top", "--logdir", logdir, "--trace-dir",
                                dirs["trace"], "--iterations", "1"],
                         capture_output=True, text=True, timeout=300)
    top = out.stdout.splitlines()
    if out.returncode != 0 or not any("MFU" in l for l in top) or \
            not any("HBM (train program)" in l for l in top) or \
            not any("health: OK" in l for l in top):
        raise AssertionError(f"observe: train_cli top gave {top}")

    report = dict(
        model="BERT-base classifier (bench.py:353-438)",
        compute_dtype="bfloat16", ids="int32", batch=TRAIN_BATCH,
        steps=OBS_STEPS, log_every=OBS_LOG_EVERY, card=smi,
        launches=launches, launches_per_step=per_step, losses=losses,
        fit_wall_s=wall, flops_per_step=flops,
        bench_flops_per_step=want_flops, peak_flops=peak,
        mfu=scalars["MFU"], step_time_ms=scalars["StepTimeMs"],
        infeed_wait_ms=scalars["InfeedWaitMs"],
        input_bound_fraction=scalars["InputBoundFraction"],
        breakdown=bd, max_memory_allocated=peak_alloc,
        memory_reserved=reserved,
        adam_leaf_bytes=adam_bytes, profiler_trace_bytes=len(prof_text),
        merged_events=len(merged), merged_kernel_events=kernel_events,
        train_cli_top=top)
    return model, x, y, report


def obs_watermark_and_oom(model, x, y, dirs):
    """Leg C: the watermark latch writes one dump holding the card's
    statistics, and a deliberate over-allocation one more through
    ``maybe_oom_forensics``."""
    debug = os.path.join(dirs["trace"], "debug")
    before = obs_files(debug, "oom-")
    with _Config(hbm_watermark_fraction=OBS_WATERMARK):
        model.fit([a[:OBS_LOG_EVERY * TRAIN_BATCH] for a in x],
                  y[:OBS_LOG_EVERY * TRAIN_BATCH], batch_size=TRAIN_BATCH,
                  nb_epoch=1)
    new = [f for f in obs_files(debug, "oom-") if f not in before]
    if len(new) != 1:
        raise AssertionError(f"observe: the watermark wrote {new}")
    with open(os.path.join(debug, new[0])) as f:
        dump = json.load(f)
    rows = dump["device_memory"].get("per_device", [])
    if not rows or not rows[0]["bytes_limit"] or \
            not rows[0]["bytes_in_use"] or "train" not in dump["programs"] \
            or not any("cuda:0" in k for k in dump["hlo_tail"]):
        raise AssertionError(f"observe: the watermark dump holds {dump}")
    watermark = dict(file=new[0], reason=dump["reason"], device=rows[0])

    before = obs_files(debug, "oom-")
    total = torch.cuda.mem_get_info()[1]
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as e:
        path = memory.maybe_oom_forensics(e, out_dir=dirs["trace"])
    else:
        raise AssertionError("observe: allocating twice the card's memory "
                             "succeeded")
    new = [f for f in obs_files(debug, "oom-") if f not in before]
    if path is None or len(new) != 1:
        raise AssertionError(f"observe: the OOM wrote {path}, {new}")
    with open(path) as f:
        dump = json.load(f)
    if dump["device_memory"]["per_device"][0]["num_ooms"] < 1:
        raise AssertionError(f"observe: the OOM dump holds "
                             f"{dump['device_memory']}")
    return dict(watermark=watermark, oom=dict(
        file=new[0], reason=dump["reason"][:200],
        device=dump["device_memory"]["per_device"][0]))


def obs_timing(model, x, y, dirs):
    """Leg D: the step with the monitor and accountant off and on, in
    alternating windows of one epoch (a synchronised step clock), after
    one unkept window; the pairs alternate their order."""
    xs = [a[:OBS_DRILL_BATCHES * TRAIN_BATCH] for a in x]
    ys = y[:OBS_DRILL_BATCHES * TRAIN_BATCH]
    model.trainer.checkpoint_dir = dirs["timed"]

    def window(on):
        clock = _StepClock()
        with _Config(health_monitor=on, memory_accounting=on):
            t0 = time.perf_counter()
            model.fit(xs, ys, batch_size=TRAIN_BATCH, nb_epoch=1,
                      checkpoint_trigger=clock)
        return list(np.diff([t0] + clock.ticks)[1:] * 1e3)

    window(True)
    times = {"off": [], "on": []}
    for i in range(OBS_TIMED_PAIRS):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            times[mode] += window(mode == "on")
    return {mode: dict(p50_ms=percentile(t, 50), p95_ms=percentile(t, 95),
                       steps=len(t)) for mode, t in times.items()}


def obs_first_step(seed, x, y, dirs):
    """The first step of a new model's ``fit`` with the FLOP counter and
    the memory accountant (a TrainSummary attached) and without, each
    synchronised, and the second step beside it."""
    out = {}
    for mode in ("off", "on", "off", "on"):
        model = ckpt_model(seed + 3)
        if mode == "on":
            model.set_tensorboard(dirs["logs"], "first_step")
        clock = _StepClock()
        model.set_checkpoint(dirs["timed"], trigger=clock)
        with _Config(health_monitor=mode == "on",
                     memory_accounting=mode == "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.fit([a[:2 * TRAIN_BATCH] for a in x], y[:2 * TRAIN_BATCH],
                      batch_size=TRAIN_BATCH, nb_epoch=1)
        ms = list(np.diff([t0] + clock.ticks) * 1e3)
        counted = model.trainer.flops_per_step is not None
        if counted != (mode == "on"):
            raise AssertionError(f"observe: first step {mode}: FLOPs "
                                 f"{model.trainer.flops_per_step}")
        out.setdefault(mode, []).append(dict(first_ms=ms[0],
                                             second_ms=ms[1]))
        del model
        collect()
    return out


def obs_drill(seed, dirs):
    """Leg B: ``step:nan@6`` with ``health_halt`` and a checkpoint every
    4 steps (TrainingHalted, halt step 6, a flight dump, ``latest`` =
    ckpt-4 with finite parameters, a resumed fit with finite, falling
    losses), then ``grad:nan@3`` without halt (state 2 latched once, the
    fit completes)."""
    x, y, _ = train_data(seed + 7, OBS_DRILL_BATCHES * TRAIN_BATCH,
                         ids=np.int32)
    debug = os.path.join(dirs["trace"], "debug")
    flights = obs_files(debug, "flight-")
    model = ckpt_model(seed + 1)
    model.set_checkpoint(dirs["drill"], trigger=SeveralIteration(CKPT_EVERY))
    os.environ["ZOO_TPU_FAULT"] = f"step:nan@{OBS_NAN_AT}"
    faults.reset()
    try:
        with _Config(health_halt=True, failure_retry_times=0):
            try:
                model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=2)
            except TrainingHalted as e:
                halted = str(e)
            else:
                raise AssertionError("observe: step:nan did not halt")
    finally:
        os.environ.pop("ZOO_TPU_FAULT", None)
        faults.reset()
    trainer = model.trainer
    health = trainer._health.summary()
    early = list(trainer.step_losses[:CKPT_EVERY])
    new_flights = [f for f in obs_files(debug, "flight-")
                   if f not in flights]
    with open(os.path.join(dirs["drill"], "latest")) as f:
        latest = f.read().strip()
    blob = serialization.load_pytree(os.path.join(dirs["drill"], latest,
                                                  "model.npz"))
    finite = all(np.isfinite(np.asarray(a)).all()
                 for a in _tree_leaves(blob["params"]))
    if trainer._health.halt_step != OBS_NAN_AT or not new_flights or \
            latest != f"ckpt-{CKPT_EVERY}" or not finite or \
            preemption_requested():
        raise AssertionError(f"observe: halt {health}, flights "
                             f"{new_flights}, latest {latest}, finite "
                             f"{finite}")
    # resume from the last good step in the same trainer (its live
    # parameters are NaN): 4 more steps of epoch 0, then epoch 1
    trainer.load_checkpoint(dirs["drill"])
    resumed_at = trainer.step
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=2)
    resumed = list(trainer.step_losses)
    # falling: the resumed run's last steps below the run's first ones
    # (steps 1-4, before the poisoned step 6)
    if resumed_at != CKPT_EVERY or \
            len(resumed) != 2 * OBS_DRILL_BATCHES - CKPT_EVERY or \
            not np.isfinite(resumed).all() or not np.isfinite(early).all() \
            or not np.mean(resumed[-CKPT_EVERY:]) < np.mean(early):
        raise AssertionError(f"observe: resumed at {resumed_at}: {resumed} "
                             f"against the first steps' {early}")

    # grad:nan@3 without halt on a fresh model
    del model, trainer
    collect()
    model = ckpt_model(seed + 2)
    model.set_tensorboard(dirs["logs"], "grad_nan")
    os.environ["ZOO_TPU_FAULT"] = f"grad:nan@{OBS_GRAD_NAN_AT}"
    faults.reset()
    try:
        with _Config(health_halt=False):
            model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    finally:
        os.environ.pop("ZOO_TPU_FAULT", None)
        faults.reset()
    g = model.trainer._health
    sentinel_alerts = [a for a in g.alerts if a["signal"] == "sentinel"]
    states = [v for _, v in obs_summary(model).get("HealthState", [])]
    if g.state != 2 or g.halted or len(sentinel_alerts) != 1 or \
            sentinel_alerts[0]["step"] != OBS_GRAD_NAN_AT or \
            model.trainer.step != OBS_DRILL_BATCHES or states != [2.0, 2.0]:
        raise AssertionError(f"observe: grad:nan gave {g.summary()}, step "
                             f"{model.trainer.step}")
    # a halt latched by the epoch end's read: step:nan@3 in one epoch of
    # 3 steps, a checkpoint every 2 and no window (every 4): no window or
    # save reads the sentinel after step 3
    del model
    collect()
    model = ckpt_model(seed + 4)
    model.set_checkpoint(dirs["drill_end"], trigger=SeveralIteration(2))
    os.environ["ZOO_TPU_FAULT"] = "step:nan@3"
    faults.reset()
    try:
        with _Config(health_halt=True, failure_retry_times=0):
            try:
                model.fit([a[:3 * TRAIN_BATCH] for a in x],
                          y[:3 * TRAIN_BATCH], batch_size=TRAIN_BATCH,
                          nb_epoch=1)
            except TrainingHalted:
                pass
            else:
                raise AssertionError("observe: step:nan@3 at the epoch's "
                                     "end did not halt")
    finally:
        os.environ.pop("ZOO_TPU_FAULT", None)
        faults.reset()
    with open(os.path.join(dirs["drill_end"], "latest")) as f:
        end_latest = f.read().strip()
    blob = serialization.load_pytree(os.path.join(dirs["drill_end"],
                                                  end_latest, "model.npz"))
    end_finite = all(np.isfinite(np.asarray(a)).all()
                     for a in _tree_leaves(blob["params"]))
    end_halt = model.trainer._health.halt_step
    if end_halt != 3 or end_latest != "ckpt-2" or not end_finite or \
            preemption_requested():
        raise AssertionError(f"observe: the epoch-end halt at {end_halt}, "
                             f"latest {end_latest}, finite {end_finite}, "
                             f"drain flag {preemption_requested()}")
    return dict(step_nan=dict(at=OBS_NAN_AT, halted=halted,
                              health=health, flight_dumps=new_flights,
                              latest=latest, latest_finite=finite,
                              first_losses=early, resumed_at=resumed_at,
                              resumed_losses=resumed),
                grad_nan=dict(at=OBS_GRAD_NAN_AT, health=g.summary(),
                              health_state_scalars=states),
                epoch_end_halt=dict(at=3, halt_step=end_halt,
                                    latest=end_latest,
                                    latest_finite=end_finite))


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def observe(seed, smi):
    """The observe phase (see the module docstring): returns the report
    and K1-K5's launches in the monitored run."""
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    dirs = {k: os.path.join(OBS_ROOT, k) for k in
            ("logs", "trace", "profile", "drill", "drill_end", "timed")}
    prior = init_nncontext()
    zoo_nncontext.set_nncontext(None)
    init_nncontext(zoo_nncontext.ZooConfig.from_env(
        health_monitor=True, memory_accounting=True, telemetry=True,
        trace_dir=dirs["trace"], profile_dir=dirs["profile"],
        profile_start_step=OBS_PROFILE_START,
        profile_num_steps=OBS_PROFILE_STEPS,
        log_every_n_steps=OBS_LOG_EVERY, failure_retry_times=0))
    t0 = time.perf_counter()
    try:
        model, x, y, report = obs_monitored_run(seed, dirs, smi)
        report["memory_forensics"] = obs_watermark_and_oom(model, x, y, dirs)
        report["timing"] = obs_timing(model, x, y, dirs)
        del model
        collect()
        report["first_step"] = obs_first_step(seed, x, y, dirs)
        report["drill"] = obs_drill(seed, dirs)
        collect()
    finally:
        zoo_nncontext.set_nncontext(prior)
    report["wall_s"] = time.perf_counter() - t0
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    return report, report["launches"]


# ---------------------------------------------------------------------------
# data: the host data layer feeding BERT-base and ResNet-50
# ---------------------------------------------------------------------------

DATA_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_data")
# leg A: 8 batches of bench.py's BERT inputs as TFRecord records
DATA_BERT_BATCHES, DATA_BERT_EPOCHS, DATA_LOG_EVERY = 8, 2, 4
DATA_BERT_WORKERS = 4
# leg B: 2,048 uint8 3 x 256 x 256 images in 8 npz shards, cropped to
# bench.py's 3 x 224 x 224; ImageNet's channel statistics (0-255 scale)
DATA_IMAGES, DATA_SHARDS, DATA_SIDE, DATA_CROP = 2048, 8, 256, 224
DATA_MEAN = (123.675, 116.28, 103.53)
DATA_STD = (58.395, 57.12, 57.375)
# the ring's share of /dev/shm's free bytes, and the most slots a worker
DATA_SHM_SHARE, DATA_MAX_SLOTS = 0.25, 3
DATA_CHAOS_AT, DATA_CHAOS_WORKERS = 3, 2


class DecodeBertRecords(Preprocessing):
    """TFRecord payloads as uint8 rows -> bench.py's four BERT inputs
    (tokens, positions, segments as int32; the mask float32) and the
    float32 label. Each record is the row's bytes in that order."""

    def __init__(self, seq_len):
        self.seq_len = seq_len

    def apply(self, batch):
        raw = np.ascontiguousarray(batch.inputs[0])
        l, n = self.seq_len, raw.shape[0]
        ints = raw[:, :12 * l].copy().view(np.int32).reshape(n, 3, l)
        mask = raw[:, 12 * l:16 * l].copy().view(np.float32)
        label = raw[:, 16 * l:].copy().view(np.float32).reshape(n)
        return MiniBatch((ints[:, 0].copy(), ints[:, 1].copy(),
                          ints[:, 2].copy(), mask.reshape(n, 1, 1, l)),
                         label, batch.weights)


class AugmentImages(Preprocessing):
    """A seeded random 224 crop and horizontal flip of each uint8 image,
    to float32, minus the channel mean over the channel std. The crops
    and flips are drawn from a generator seeded by the batch's labels, so
    any worker (or the serial run) transforms a batch the same way.
    ``cpu_bound``: per-image Python slicing that threads serialise."""

    cpu_bound = True

    def __init__(self, seed, crop=DATA_CROP):
        self.seed, self.crop = seed, crop
        self.mean = np.asarray(DATA_MEAN, np.float32).reshape(1, 3, 1, 1)
        self.inv_std = 1.0 / np.asarray(DATA_STD,
                                        np.float32).reshape(1, 3, 1, 1)

    def apply(self, batch):
        x = np.asarray(batch.inputs[0])
        n, _, h, w = x.shape
        rs = np.random.default_rng(
            [self.seed, zlib.crc32(np.ascontiguousarray(
                batch.targets).tobytes())])
        oy = rs.integers(0, h - self.crop + 1, n)
        ox = rs.integers(0, w - self.crop + 1, n)
        flip = rs.random(n) < 0.5
        out = np.empty((n, x.shape[1], self.crop, self.crop), np.float32)
        for i in range(n):
            img = x[i, :, oy[i]:oy[i] + self.crop, ox[i]:ox[i] + self.crop]
            out[i] = img[:, :, ::-1] if flip[i] else img
        out -= self.mean
        out *= self.inv_std
        return MiniBatch((out,), batch.targets, batch.weights)


def batch_crc(batch):
    """The native crc32c of a batch's arrays, in order."""
    crc = 0
    for a in list(batch.inputs) + [batch.targets, batch.weights]:
        crc = crc32c(np.ascontiguousarray(a), crc)
    return crc


def data_window(model, fs, batch, root):
    """One epoch of ``fit`` with a synchronised clock after each step:
    (step ms, the TrainSummary's new (tag, value) pairs)."""
    clock = _StepClock()
    model._ensure_trainer().checkpoint_dir = root
    before = len(model.get_train_summary())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(fs, batch_size=batch, nb_epoch=1, checkpoint_trigger=clock)
    steps = list(np.diff([t0] + clock.ticks) * 1e3)
    new = [(tag, float(v)) for _, _, tag, v in
           model.get_train_summary()[before:]]
    return steps, new


def scalars_of(pairs, tag):
    return [v for t, v in pairs if t == tag]


def data_leg_a(seed, root):
    """BERT-base bf16 from a TFRecord file through a DRAM-cached
    TransformedFeatureSet on 4 threads (see the module docstring)."""
    l = BERT_CONFIG["seq_len"]
    n = DATA_BERT_BATCHES * TRAIN_BATCH
    x, y, _ = train_data(seed + 31, n, ids=np.int32)
    raw = np.concatenate(
        [a.reshape(n, -1).view(np.uint8) for a in x[:3]]
        + [x[3].reshape(n, l).view(np.uint8), y.reshape(n, 1).view(np.uint8)],
        axis=1)
    path = os.path.join(root, "bert.tfrecord")
    t0 = time.perf_counter()
    write_tfrecord(path, (row.tobytes() for row in raw))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    records = list(read_tfrecord(path, verify_crc=True))
    read_s = time.perf_counter() - t0
    got = np.stack([np.frombuffer(r, np.uint8) for r in records])
    if not np.array_equal(got, raw):
        raise AssertionError("data: the TFRecord file read back differs")
    file_bytes = os.path.getsize(path)

    fs = FeatureSet.rdd(FeatureSet.array(got).transform(
        DecodeBertRecords(l)), "DRAM")
    model = ckpt_model(seed)
    model.set_tensorboard(os.path.join(root, "logs"), "leg_a")
    clock = _StepClock()
    model._ensure_trainer().checkpoint_dir = os.path.join(root, "none")
    _kernels.LAUNCHES.reset()
    model.fit(fs, batch_size=TRAIN_BATCH, nb_epoch=DATA_BERT_EPOCHS,
              checkpoint_trigger=clock)
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES.snapshot()
    losses = list(model.trainer.step_losses)
    stats = fs.stats().as_dict()
    summary = [(tag, float(v)) for _, _, tag, v in model.get_train_summary()]
    del model
    collect()

    steps = DATA_BERT_BATCHES * DATA_BERT_EPOCHS
    per_step = {k: v / steps for k, v in launches.items()}
    want = {attn.KERNEL_NAME: CKPT_BLOCKS, attn.DQ_KERNEL_NAME: CKPT_BLOCKS,
            attn.DKV_KERNEL_NAME: CKPT_BLOCKS,
            dln.FWD_KERNEL_NAME: 2 * CKPT_BLOCKS,
            dln.BWD_KERNEL_NAME: 2 * CKPT_BLOCKS}
    if per_step != want:
        raise AssertionError(f"data: leg A launched {per_step} a step")
    if stats["cache_hits"] != DATA_BERT_BATCHES or \
            stats["batches_transformed"] != DATA_BERT_BATCHES:
        raise AssertionError(f"data: the DRAM cache gave {stats}")

    # the same weights fed the decoded arrays from memory: epoch 1's
    # losses equal bit for bit
    ref = ckpt_model(seed)
    ref.fit(ArrayFeatureSet(x, y), batch_size=TRAIN_BATCH, nb_epoch=1)
    ref_losses = list(ref.trainer.step_losses)
    del ref
    collect()
    if losses[:DATA_BERT_BATCHES] != ref_losses or \
            not np.isfinite(losses).all():
        raise AssertionError(f"data: leg A's epoch 1 {losses} against the "
                             f"in-memory fit's {ref_losses}")
    step_ms = list(np.diff(clock.ticks) * 1e3)
    return launches, dict(
        records=n, record_bytes=int(raw.shape[1]), file_bytes=file_bytes,
        write_s=write_s, read_s=read_s,
        read_mb_per_s=file_bytes / read_s / 1e6, read_equal=True,
        transform_workers=DATA_BERT_WORKERS, backend="thread",
        cache=stats, launches=launches, launches_per_step=per_step,
        losses=losses, epoch1_equal_in_memory_fit=True,
        step_p50_ms=percentile(step_ms, 50),
        infeed_wait_ms=scalars_of(summary, "InfeedWaitMs"),
        input_bound_fraction=scalars_of(summary, "InputBoundFraction"))


def data_shards(seed, root):
    """Leg B's npz shards of uint8 images and int32 labels."""
    rs = np.random.default_rng(seed + 41)
    per = DATA_IMAGES // DATA_SHARDS
    paths = []
    t0 = time.perf_counter()
    for s in range(DATA_SHARDS):
        p = os.path.join(root, f"images-{s:02d}.npz")
        DiskFeatureSet.write_shard(
            p, rs.integers(0, 256, (per, 3, DATA_SIDE, DATA_SIDE),
                           dtype=np.uint8),
            rs.integers(0, RESNET_CLASSES, per).astype(np.int32))
        paths.append(p)
    return paths, time.perf_counter() - t0


def data_pool_pass(base, chain, workers, stats=None, steady_after=None):
    """``base`` through a ProcessTransformPool: the batches' checksums,
    the first batch's latency (the pool's start), the pool's counts, and
    with ``steady_after`` the batches a second after that many (the
    pool's rate once every worker has started)."""
    t0 = time.perf_counter()
    pool = ProcessTransformPool(base, chain, num_workers=workers,
                                stats=stats)
    crcs, arrived = [], []
    try:
        for b in pool:
            arrived.append(time.perf_counter() - t0)
            crcs.append(batch_crc(b))
            del b
    finally:
        pool.close()
    out = dict(first_batch_s=arrived[0], wall_s=time.perf_counter() - t0,
               batches=len(crcs), **pool.pool_stats())
    if steady_after is not None:
        tail = arrived[steady_after - 1:]
        out["steady_batches_per_s"] = (len(tail) - 1) / (tail[-1] - tail[0])
    return crcs, out


def data_copy_ms(host, device):
    """The host-to-card copy of one transformed ResNet batch: pageable
    (``as_device_tensor``) against the pinned side-stream stager (the
    buffer's fill and the copy), synchronised, 5 of each in turns."""
    stager = PinnedStager(device, depth=2)
    for _ in range(stager.slots):   # allocate every pinned buffer first
        stager.put(host)
    times = {"pageable": [], "pinned": []}
    for i in range(6):
        for mode in (("pageable", "pinned") if i % 2 else
                     ("pinned", "pageable")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "pinned":
                dev, event = stager.put(host)
                torch.cuda.current_stream().wait_event(event)
            else:
                dev = [as_device_tensor(a, device) for a in
                       (host.inputs[0], host.targets, host.weights)]
            torch.cuda.synchronize()
            if i:
                times[mode].append((time.perf_counter() - t0) * 1e3)
            del dev
    return {k: percentile(v, 50) for k, v in times.items()}


def data_leg_b(seed, root, smi):
    """ResNet-50 bf16 at batch 256 from npz shards through a process
    pool, against the same rows pre-transformed in memory; then the
    chaos leg (C). See the module docstring."""
    paths, write_s = data_shards(seed, root)
    workers = min(8, os.cpu_count() or 1)
    chain = AugmentImages(seed)
    files = FeatureSet.files(paths)
    epoch_seed = seed + 5

    # the serial transform: checksums, and the rows pre-transformed
    t0 = time.perf_counter()
    serial = [chain(b) for b in files.batches(RESNET_BATCH, shuffle=True,
                                              seed=epoch_seed)]
    serial_s = time.perf_counter() - t0
    want = [batch_crc(b) for b in serial]
    arrays, _ = flatten_batch(serial[0])
    slot = slot_nbytes(arrays)
    shm_free = shutil.disk_usage("/dev/shm").free
    slots = min(DATA_MAX_SLOTS,
                int(DATA_SHM_SHARE * shm_free // (workers * slot)))
    if slots < 1:
        raise AssertionError(f"data: /dev/shm has {shm_free} bytes free, "
                             f"too few for one {slot}-byte slot a worker")
    x_mem = np.concatenate([b.inputs[0] for b in serial])
    y_mem = np.concatenate([b.targets for b in serial])
    copy_ms = data_copy_ms(serial[0], torch.device("cuda", 0))
    del serial, arrays
    env = {"ZOO_TPU_INFEED_SLOT_BYTES": str(slot),
           "ZOO_TPU_INFEED_SLOTS": str(slots)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        # two epochs' batches through one pool: the first against the
        # serial transform, the second for the pool's rate once started
        # (depth: three before PR 18)
        stats = TransformStats()
        got, pool = data_pool_pass(
            itertools.chain(*(files.batches(RESNET_BATCH, shuffle=True,
                                            seed=epoch_seed + e)
                              for e in range(2))),
            chain, workers, stats, steady_after=len(want) + 1)
        got = got[:len(want)]
        if got != want or pool["shm_batches"] < 1:
            raise AssertionError(f"data: the pool's checksums {got} against "
                                 f"the serial {want}; {pool}")
        # C: a worker killed after its 3rd batch, respawned; on
        # DATA_CHAOS_WORKERS workers, so that each transforms more than 3
        # of the epoch's 8 batches
        state = os.path.join(root, "faults")
        os.makedirs(state, exist_ok=True)
        os.environ["ZOO_TPU_FAULT"] = f"infeed-worker:kill@{DATA_CHAOS_AT}"
        os.environ["ZOO_TPU_FAULT_STATE"] = state
        faults.reset()
        try:
            chaos, chaos_pool = data_pool_pass(
                files.batches(RESNET_BATCH, shuffle=True, seed=epoch_seed),
                chain, DATA_CHAOS_WORKERS)
        finally:
            os.environ.pop("ZOO_TPU_FAULT", None)
            os.environ.pop("ZOO_TPU_FAULT_STATE", None)
            faults.reset()
        fired = os.listdir(state)
        if chaos != want or chaos_pool["respawns"] < 1 or not fired:
            raise AssertionError(f"data: after the kill {chaos} against "
                                 f"{want}; {chaos_pool}, markers {fired}")

        # the fit: in memory against the shards, alternating windows
        clf = build_resnet(seed + 43)
        clf.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
        clf.model.set_compute_dtype("bfloat16")
        clf.model.set_tensorboard(os.path.join(root, "logs"), "leg_b")
        mem = ArrayFeatureSet(x_mem, y_mem)
        disk = FeatureSet.files(paths).transform(chain)
        sources = {"memory": mem, "disk": disk}
        with _Config(transform_workers=workers, infeed_backend="process"):
            _kernels.LAUNCHES.reset()
            data_window(clf.model, mem, RESNET_BATCH, root)   # warm-up
            windows = {"memory": [], "disk": []}
            for mode in ("memory", "disk", "disk", "memory"):
                windows[mode].append(data_window(
                    clf.model, sources[mode], RESNET_BATCH, root))
            torch.cuda.synchronize()
            launches = _kernels.LAUNCHES.snapshot()
        losses = list(clf.model.trainer.step_losses)
        del clf
        collect()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if launches or not np.isfinite(losses).all():
        raise AssertionError(f"data: the ResNet-50 fit launched {launches}, "
                             f"losses {losses}")
    timing = {}
    for mode, ws in windows.items():
        steady = [t for steps, _ in ws for t in steps[1:]]
        pairs = [p for _, new in ws for p in new]
        timing[mode] = dict(
            step_p50_ms=percentile(steady, 50),
            first_step_ms=[steps[0] for steps, _ in ws],
            steady_images_per_s=RESNET_BATCH * len(steady) / sum(steady)
            * 1e3,
            epoch_images_per_s=[RESNET_BATCH * len(steps) / sum(steps) * 1e3
                                for steps, _ in ws],
            input_bound_fraction=scalars_of(pairs, "InputBoundFraction"),
            infeed_wait_ms=scalars_of(pairs, "InfeedWaitMs"),
            infeed_workers=scalars_of(pairs, "InfeedWorkers"),
            infeed_worker_utilization=scalars_of(
                pairs, "InfeedWorkerUtilization"))
    if timing["disk"]["infeed_workers"] != \
            [float(workers)] * len(timing["disk"]["infeed_workers"]) or \
            not timing["disk"]["infeed_workers"]:
        raise AssertionError(f"data: InfeedWorkers {timing['disk']}")
    return dict(
        images=DATA_IMAGES, shards=DATA_SHARDS, image_shape=(3, DATA_SIDE,
                                                             DATA_SIDE),
        shard_bytes=sum(os.path.getsize(p) for p in paths),
        write_s=write_s, crop=DATA_CROP, batch=RESNET_BATCH,
        cpu_count=os.cpu_count(), workers=workers, backend="process",
        slot_bytes=slot, slots_per_worker=slots, shm_free_bytes=shm_free,
        serial_transform_s=serial_s, checksums_equal=True, pool=pool,
        transform_stats=stats.as_dict(), copy_ms=copy_ms, card=smi,
        timing=timing, k1_k5_launches=launches, losses=losses,
        chaos=dict(fault=f"infeed-worker:kill@{DATA_CHAOS_AT}",
                   workers=DATA_CHAOS_WORKERS, markers=fired,
                   checksums_equal=True, **chaos_pool))


def data(seed, smi):
    """The data phase (see the module docstring): returns the report and
    K1-K5's launches in leg A's fit."""
    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    os.makedirs(DATA_ROOT)
    prior = init_nncontext()
    zoo_nncontext.set_nncontext(None)
    init_nncontext(zoo_nncontext.ZooConfig.from_env(
        transform_workers=DATA_BERT_WORKERS, log_every_n_steps=DATA_LOG_EVERY,
        failure_retry_times=0))
    t0 = time.perf_counter()
    try:
        launches, leg_a = data_leg_a(seed, DATA_ROOT)
        leg_b = data_leg_b(seed, DATA_ROOT, smi)
    finally:
        zoo_nncontext.set_nncontext(prior)
        shutil.rmtree(DATA_ROOT, ignore_errors=True)
    chaos = leg_b.pop("chaos")
    return dict(card=smi, leg_a=leg_a, leg_b=leg_b, leg_c=chaos,
                wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------
# 17. detect: image features without OpenCV, SSD-300 on the card
# ---------------------------------------------------------------------------

DETECT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_detect")
# the reference's object-detection flow at the repo's full detector width
# (ObjectDetector's defaults: 21 classes, SSD-300, base 32 channels, six
# scales, 8,744 priors)
DETECT_CLASSES, DETECT_IMAGES, DETECT_BATCH = 21, 32, 8
DETECT_SIZES = ((375, 500), (480, 640))
DETECT_TRAIN_BATCH, DETECT_TRAIN_STEPS = 16, 4
DETECT_JPEG_QUALITY = 90
# the head output, card against the port's CPU forward of the same
# weights on the same batch (float32, TF32 off): 14 convolutions summed in
# another order, 1e-4 of the output's largest magnitude
DETECT_HEAD_TOL = 1e-4
# detections whose score is this far from every other detection's score
# (and from the threshold) are held to the CPU's, class for class, with
# the score within the same gap and the box within 1e-3 pixels per pixel
# of image edge
DETECT_SCORE_GAP = 1e-4
DETECT_BOX_TOL = 1e-3
# the first training step, card against CPU from the same weights: the
# loss within 1e-4 relative; every head's gradient within 1e-3 of its
# norm; fit's first loss within 1e-5 relative of the card's step
DETECT_LOSS_TOL = 1e-4
DETECT_FIT_LOSS_TOL = 1e-5
# hard-negative mining ranks background priors by cross-entropy: where
# two lie within rounding (1e-4 relative) the card and the CPU may pick
# either; the gradients are then compared under the card's picks
DETECT_MINING_TIE = 1e-4
DETECT_GRAD_TOL = 1e-3
# the classifier leg against the CPU: its pre-softmax logits (the last
# Dense's matmul + bias; random weights saturate the softmax, which would
# hide a wrong forward) within 1e-4 of their largest magnitude: ResNet-50's
# 53 float32 convolutions summed in another order (TF32 off); and the
# probabilities within 1e-4
DETECT_LOGIT_TOL = 1e-4
DETECT_PROB_TOL = 1e-4


def detect_scene(rs, h, w, k):
    """A smooth colour gradient with a few filled rectangles."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                    (np.sin(xx / 37.0 + k) + np.cos(yy / 23.0)) * 60 + 128],
                   -1)
    for _ in range(3):
        y0, x0 = int(rs.integers(0, h * 3 // 4)), int(rs.integers(0, w * 3 //
                                                                 4))
        img[y0:y0 + int(rs.integers(h // 8, h // 3)),
            x0:x0 + int(rs.integers(w // 8, w // 3))] = rs.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_detect_images(seed, root):
    """DETECT_IMAGES seeded images in two class folders, half baseline
    JPEG from the port's encoder and half PNG, at 375 x 500 and 480 x 640.
    Returns {path: (original pixels, the in-memory decode of the bytes)}."""
    rs = np.random.default_rng(seed)
    written = {}
    for i in range(DETECT_IMAGES):
        h, w = DETECT_SIZES[i % 2]
        img = detect_scene(rs, h, w, i)
        folder = os.path.join(root, "cls_a" if i < DETECT_IMAGES // 2
                              else "cls_b")
        os.makedirs(folder, exist_ok=True)
        if (i // 2) % 2:
            path = os.path.join(folder, f"img{i:02d}.png")
            data = codec.encode_png(img)
        else:
            path = os.path.join(folder, f"img{i:02d}.jpg")
            data = codec.encode_jpeg(img, DETECT_JPEG_QUALITY)
        with open(path, "wb") as f:
            f.write(data)
        written[path] = (img, codec.decode(data, path))
    return written


# the codec's other modes: committed JPEG files (tools/
# make_codec_fixtures.py writes them, with OpenCV's pixels as a SHA-256:
# no OpenCV here) and Adam7-interlaced PNGs written from seeded pixels
CODEC_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "codec_fixtures")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
ADAM7_SIZES = ((1, 1), (37, 50), (96, 128))


def png_filtered(rows, bpp):
    """PNG rows (h, stride) uint8 with the five filters in turn, each
    from the raw bytes as PNG defines them."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        ft, b = r % 5, prev
        if ft == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = (0, a, b, (a + b) // 2)[ft]
        out.append(bytes([ft]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def adam7_png(px, ctype, depth):
    """(h, w, c) samples (uint8, or uint16 at depth 16) as an
    Adam7-interlaced PNG of colour type ``ctype``."""
    h, w, c = px.shape
    big = px.astype(">u2") if depth == 16 else px.astype(np.uint8)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        part = big[y0::dy, x0::dx]
        if part.size:
            rows = np.frombuffer(part.tobytes(), np.uint8).reshape(
                part.shape[0], -1)
            raw += png_filtered(rows, c * depth // 8)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       1)) +
            chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def codec_modes_leg(seed):
    """The JPEG fixtures decode to OpenCV's pixels (their SHA-256), and
    seeded Adam7 PNGs (RGB 8-bit, grey 16-bit) to the written pixels."""
    t0 = time.perf_counter()
    with open(os.path.join(CODEC_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in sorted(manifest.items()):
        px = codec.imread(os.path.join(CODEC_FIXTURES, name))
        digest = hashlib.sha256(np.ascontiguousarray(px).tobytes())
        if list(px.shape) != want["shape"] or \
                digest.hexdigest() != want["opencv_sha256"]:
            raise AssertionError(f"{name}: decoded pixels are not "
                                 f"OpenCV's ({px.shape})")
    rs = np.random.default_rng(seed)
    n_png = 0
    for h, w in ADAM7_SIZES:
        rgb = rs.integers(0, 256, (h, w, 3)).astype(np.uint8)
        grey = rs.integers(0, 65536, (h, w, 1)).astype(np.uint16)
        for px, ctype, depth, want in (
                (rgb, 2, 8, rgb[:, :, ::-1]),
                (grey, 0, 16, np.repeat((grey >> 8).astype(np.uint8), 3,
                                        axis=2))):
            got = codec.decode(adam7_png(px, ctype, depth), "adam7.png")
            if not np.array_equal(got, want):
                raise AssertionError(f"Adam7 PNG {h} x {w} colour type "
                                     f"{ctype}: decoded pixels differ")
            n_png += 1
    return dict(jpeg_fixtures=sorted(manifest), jpeg_opencv=sorted(
        {v["opencv"] for v in manifest.values()}), adam7_pngs=n_png,
        modes_wall_s=time.perf_counter() - t0)


def detect_codec_leg(written, seed=0):
    """Leg D: every written file decoded again from disk equals what was
    encoded (PNG) or the in-memory decode of the same bytes (JPEG, the
    same C++ code; its distance from the drawn pixels is reported); then
    the codec's progressive, CMYK/YCCK and Adam7 modes
    (:func:`codec_modes_leg`)."""
    modes = codec_modes_leg(seed)
    t0 = time.perf_counter()
    jpeg_err = 0
    for path, (img, first) in written.items():
        got = codec.imread(path)
        want = img if path.endswith(".png") else first
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{path}: decoded again it is not what was "
                                 "written")
        if path.endswith(".jpg"):
            jpeg_err = max(jpeg_err, int(np.abs(got.astype(int) - img).max()))
    return dict(files=len(written), decode_wall_s=time.perf_counter() - t0,
                png_bit_equal=True, jpeg_equal_to_in_memory_decode=True,
                jpeg_max_abs_err_vs_drawn=jpeg_err,
                jpeg_quality=DETECT_JPEG_QUALITY,
                cv2_importable=importlib.util.find_spec("cv2") is not None,
                **modes)


def detect_group(name: str) -> str:
    """Kernel groups of the detector's profile."""
    low = name.lower()
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad",
                              "implicit", "cudnn")):
        return "convolution (cuDNN)"
    if "norm" in low:
        return "batch norm"
    if "softmax" in low:
        return "softmax"
    if "sort" in low or "radix" in low:
        return "sort (argsort)"
    return kernel_group(name)


def match_detections(card, cpu, threshold):
    """The card's detection rows against the CPU's: every card row whose
    score is DETECT_SCORE_GAP clear of the other rows' scores and of the
    threshold has a CPU row of the same class, score and box. Returns the
    number of rows held."""
    held = 0
    scores = card[:, 1]
    for i, row in enumerate(card):
        others = np.delete(scores, i)
        if abs(row[1] - threshold) <= DETECT_SCORE_GAP or (
                len(others) and np.abs(others - row[1]).min() <=
                DETECT_SCORE_GAP):
            continue
        near = cpu[(cpu[:, 0] == row[0]) &
                   (np.abs(cpu[:, 1] - row[1]) <= DETECT_SCORE_GAP)]
        if not len(near) or np.abs(near[:, 2:] - row[2:]).max(axis=1).min() \
                > DETECT_BOX_TOL * DETECT_SIZES[1][1]:
            raise AssertionError(f"card detection {row.tolist()} has no "
                                 "CPU twin")
        held += 1
    return held


def detect_serve_leg(det, cpu_det, root, smi):
    """Leg A: ImageSet.read -> ObjectDetector.predict_image_set on the
    card, against the CPU twin; the time split and a profile."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iset = ImageSet.read(root, with_label=True)
    read_s = time.perf_counter() - t0
    if len(iset) != DETECT_IMAGES or sorted(iset.label_map.values()) != \
            [1, 2]:
        raise AssertionError(f"read {len(iset)} images, labels "
                             f"{iset.label_map}")
    t1 = time.perf_counter()
    out = det.predict_image_set(iset, batch_size=DETECT_BATCH)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    feats = out.features
    arrays = np.stack([f.get_sample().features[0] for f in feats])
    if arrays.shape != (DETECT_IMAGES, 3, 300, 300):
        raise AssertionError(f"preprocessed batch {arrays.shape}")
    # the gates: the head output and every image's rows against the CPU
    head = det.forward_device(arrays[:DETECT_BATCH])
    cpu_head = cpu_det.forward_device(arrays[:DETECT_BATCH])
    scale = float(cpu_head.abs().max())
    head_err = float((head.float().cpu() - cpu_head).abs().max())
    if tuple(head.shape) != (DETECT_BATCH, 8744, 4 + DETECT_CLASSES) or \
            not torch.isfinite(head).all() or \
            head_err > DETECT_HEAD_TOL * max(1.0, scale):
        raise AssertionError(f"head output {tuple(head.shape)} off the "
                             f"CPU's by {head_err} (scale {scale})")
    cpu_rows = cpu_det.detect(arrays, DETECT_BATCH)
    n_rows = held = 0
    for f, crow in zip(feats, cpu_rows):
        rows = f["detection"]
        h, w = f["original_height"], f["original_width"]
        if rows.ndim != 2 or rows.shape[1] != 6 or not np.isfinite(
                rows).all():
            raise AssertionError(f"{f['uri']}: rows {rows.shape}")
        if (rows[:, [2, 4]] > w + 1e-3).any() or \
                (rows[:, [3, 5]] > h + 1e-3).any():
            raise AssertionError(f"{f['uri']}: a box outside {w} x {h}")
        keep = crow[:, 1] > 0
        cpu_scaled = crow[keep].copy()
        cpu_scaled[:, [2, 4]] *= w
        cpu_scaled[:, [3, 5]] *= h
        held += match_detections(rows, cpu_scaled, det.conf_threshold)
        n_rows += len(rows)
    # a second pass, warm, for images/s; then the time split: decode,
    # preprocess, forward, detection_output
    torch.cuda.synchronize()
    tw = time.perf_counter()
    det.predict_image_set(ImageSet.read(root, with_label=True),
                          batch_size=DETECT_BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    t2 = time.perf_counter()
    again = ImageSet.read(root, with_label=True)
    decode_s = time.perf_counter() - t2
    t3 = time.perf_counter()
    again.transform(det.config.pre_processor)
    preprocess_s = time.perf_counter() - t3
    forward_s = post_s = 0.0
    for i in range(0, DETECT_IMAGES, DETECT_BATCH):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        preds = det.forward_device(arrays[i:i + DETECT_BATCH])
        torch.cuda.synchronize()
        tb = time.perf_counter()
        det.postprocess(preds)
        torch.cuda.synchronize()
        forward_s += tb - ta
        post_s += time.perf_counter() - tb
    batch = arrays[:DETECT_BATCH]
    prof = profile_device(lambda: det.postprocess(det.forward_device(batch)),
                          group_of=detect_group)
    launches = sum(g["launches"] for g in (prof["groups"] or {}).values())
    return dict(
        images=DETECT_IMAGES, batch=DETECT_BATCH, sizes=DETECT_SIZES,
        rows=n_rows, rows_held_to_cpu=held,
        conf_threshold=det.conf_threshold,
        head_max_abs_err=head_err, head_scale=scale,
        head_tol=DETECT_HEAD_TOL,
        first_pass_s=dict(read=read_s, predict_image_set=predict_s),
        images_per_s=DETECT_IMAGES / warm_s, warm_pass_s=warm_s,
        split_s=dict(decode=decode_s, preprocess=preprocess_s,
                     forward=forward_s, detection_output=post_s),
        launches_per_batch=launches, profile_one_batch=prof,
        card=smi), arrays


def detect_mining_flips(card_keep, cpu_keep, cpu_pred, cpu_y):
    """The priors the card's hard-negative mining chose and the CPU's did
    not, and back: each image's two sets are as large, and the CPU's
    cross-entropy of every swapped prior within DETECT_MINING_TIE of the
    others (a near tie broken the other way, not a wrong selection).
    Returns the count of swapped pairs."""
    ce = tssd.MultiBoxLoss._cross_entropy(cpu_pred.detach(),
                                          cpu_y[..., 4].long())
    swapped = 0
    for b in range(card_keep.shape[0]):
        only_card = ce[b][card_keep[b] & ~cpu_keep[b]]
        only_cpu = ce[b][cpu_keep[b] & ~card_keep[b]]
        if len(only_card) != len(only_cpu):
            raise AssertionError(f"image {b}: the card mined "
                                 f"{int(card_keep[b].sum())} priors, the "
                                 f"CPU {int(cpu_keep[b].sum())}")
        if len(only_card):
            gap = float(only_cpu.max() - only_card.min())
            if gap > DETECT_MINING_TIE * float(only_cpu.max()):
                raise AssertionError(f"image {b}: mined priors differ by "
                                     f"a cross-entropy gap of {gap}")
            swapped += len(only_card)
    return swapped


def detect_train_leg(det, cpu_det, arrays, seed):
    """Leg B: MultiBoxLoss on encode_targets of seeded boxes; the first
    step's loss and gradients on the fit batch against the CPU's; four
    fit steps at batch 16, the first's loss the card step's; every loss
    finite, every gradient finite after step 1; the step times and the
    leg's own peak memory."""
    rs = np.random.default_rng(seed)
    boxes, labels = [], []
    for _ in range(DETECT_TRAIN_BATCH):
        k = int(rs.integers(1, 4))
        xy = rs.uniform(0.0, 0.6, (k, 2))
        boxes.append(np.concatenate(
            [xy, xy + rs.uniform(0.1, 0.4, (k, 2))], 1).astype(np.float32))
        labels.append(rs.integers(1, DETECT_CLASSES, k))
    y = det.encode_targets(boxes, labels)
    x = arrays[:DETECT_TRAIN_BATCH]
    if y.shape != (DETECT_TRAIN_BATCH, 8744, 5) or not (y[..., 4] > 0).any():
        raise AssertionError(f"targets {y.shape}")
    # the first step on the fit batch, card against CPU: the loss with
    # each side's own hard negatives; the gradients with the card's
    loss_fn = tssd.MultiBoxLoss(DETECT_CLASSES)
    runs = {}
    for name, model, dev in (("card", det.model, init_nncontext().device),
                             ("cpu", cpu_det.model, torch.device("cpu"))):
        model.to(dev)
        model.zero_grad(set_to_none=True)
        xs, ys = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        pred = model([xs], training=True)
        runs[name] = (pred, ys, loss_fn.selection(pred, ys))
    card_pred, card_y, card_keep = runs["card"]
    cpu_pred, cpu_y, cpu_keep = runs["cpu"]
    card_loss = loss_fn.masked_loss(card_pred, card_y, card_keep).mean()
    cpu_loss = loss_fn.masked_loss(cpu_pred, cpu_y, cpu_keep).mean().item()
    flips = detect_mining_flips(card_keep.cpu(), cpu_keep, cpu_pred, cpu_y)
    card_loss.backward()
    loss_fn.masked_loss(cpu_pred, cpu_y, card_keep.cpu()).mean().backward()
    card_loss = card_loss.item()
    cpu_params = dict(cpu_det.model.named_parameters())
    worst, worst_name = 0.0, None
    for name, p in det.model.named_parameters():
        if name.startswith("head"):
            g, w = p.grad.cpu(), cpu_params[name].grad
            rel = float((g - w).norm() / max(float(w.norm()), 1e-12))
            if rel > worst:
                worst, worst_name = rel, name
    loss_err = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-12)
    if loss_err > DETECT_LOSS_TOL or worst > DETECT_GRAD_TOL:
        raise AssertionError(f"first step off the CPU's: loss {loss_err}, "
                             f"gradient {worst} ({worst_name})")
    det.model.zero_grad(set_to_none=True)
    # fit, one step a call, timed
    det.compile(optimizer="sgd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not this leg's
    base = torch.cuda.memory_allocated()
    losses, walls = [], []
    for step in range(DETECT_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.model.fit(x, y, batch_size=DETECT_TRAIN_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.extend(det.model.trainer.step_losses)
        if step == 0:
            for name, p in det.model.named_parameters():
                if p.grad is None or not torch.isfinite(p.grad).all():
                    raise AssertionError(f"{name}: no finite gradient "
                                         "after step 1")
    peak = torch.cuda.max_memory_allocated() - base
    fit_err = abs(losses[0] - card_loss) / max(abs(card_loss), 1e-12)
    if len(losses) != DETECT_TRAIN_STEPS or not np.isfinite(losses).all() \
            or fit_err > DETECT_FIT_LOSS_TOL:
        raise AssertionError(f"detector losses {losses}, the first "
                             f"{fit_err} off the card step's")
    return dict(batch=DETECT_TRAIN_BATCH, steps=DETECT_TRAIN_STEPS,
                losses=losses, card_loss=card_loss,
                cpu_loss=cpu_loss, loss_rel_err=loss_err,
                fit_first_loss_rel_err=fit_err, mining_flips=flips,
                loss_tol=DETECT_LOSS_TOL, head_grad_rel_err=worst,
                head_grad_rel_err_param=worst_name,
                grad_tol=DETECT_GRAD_TOL, fit_step_walls_s=walls,
                fit_step_p50_ms=1e3 * percentile(walls[1:], 50),
                peak_memory_bytes=peak, allocated_before_bytes=base)


def output_dense_inputs(model):
    """A forward hook on ``model``'s output Dense (matmul + bias +
    softmax) that keeps each call's input, and the layer: the logits are
    ``x @ kernel + bias`` of what it kept."""
    dense = model.graph_function().layers[-1]
    if type(dense).__name__ != "Dense":
        raise AssertionError(f"the classifier ends in {dense!r}")
    kept = []
    handle = dense.register_forward_hook(
        lambda layer, args, out: kept.append(args[0].detach()))
    return dense, kept, handle


def detect_classifier_leg(seed, root):
    """Leg C: ImageClassifier("resnet-50", 10).predict_image_set through
    its default chain (imagenet_preprocess); one image's logits and
    probabilities against the CPU."""
    def make():
        return ImageClassifier(class_num=10, model_name="resnet-50")
    clf = seeded_zoo_model(make, seed)
    twin = seeded_zoo_model(make, seed)
    twin.model.trainer = SPMDTrainer(twin.model, get_loss("mse"),
                                     get_optimizer("sgd"), device="cpu")
    dense, kept, handle = output_dense_inputs(clf.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = clf.predict_image_set(ImageSet.read(root),
                                    batch_size=DETECT_BATCH)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    wall = time.perf_counter() - t0
    feats = out.features
    for f in feats:
        if len(f["clses"]) != 5 or len(f["probs"]) != 5 or \
                not np.isfinite(f["probs"]).all():
            raise AssertionError(f"{f['uri']}: clses {f['clses']}")
    x = feats[0].get_sample().features[0][None]
    cpu_dense, cpu_kept, cpu_handle = output_dense_inputs(twin.model)
    try:
        want = twin.model.trainer.predict(x, batch_size=1)[0]
    finally:
        cpu_handle.remove()
    err = float(np.abs(feats[0]["predict"] - want).max())
    with torch.no_grad():
        logits = (kept[0][:1].float() @ dense.kernel.float() +
                  dense.bias.float()).cpu()
        cpu_logits = cpu_kept[0][:1] @ cpu_dense.kernel + cpu_dense.bias
    scale = float(cpu_logits.abs().max())
    logit_err = float((logits - cpu_logits).abs().max())
    if x.shape != (1, 3, 224, 224) or tuple(logits.shape) != (1, 10) or \
            not torch.isfinite(logits).all() or \
            logit_err > DETECT_LOGIT_TOL * max(1.0, scale) or \
            err > DETECT_PROB_TOL:
        raise AssertionError(f"classifier logits off the CPU's by "
                             f"{logit_err} (scale {scale}), "
                             f"probabilities by {err}")
    return dict(model="resnet-50", classes=10, images=len(feats),
                wall_s=wall, images_per_s=len(feats) / wall,
                cpu_logit_max_abs_err=logit_err, logit_scale=scale,
                logit_tol=DETECT_LOGIT_TOL,
                cpu_prob_max_abs_err=err, prob_tol=DETECT_PROB_TOL)


def detect_phase(seed, smi):
    """The detect phase (see the module docstring): returns the report
    and K1-K5's launches over the phase."""
    shutil.rmtree(DETECT_ROOT, ignore_errors=True)
    os.makedirs(DETECT_ROOT)
    t0 = time.perf_counter()
    _kernels.LAUNCHES.reset()
    try:
        written = write_detect_images(seed + 70, DETECT_ROOT)
        write_s = time.perf_counter() - t0

        def make():
            return ObjectDetector(class_num=DETECT_CLASSES)
        det = seeded_zoo_model(make, seed + 71)
        cpu_det = seeded_zoo_model(make, seed + 71)
        cpu_det.model.trainer = SPMDTrainer(
            cpu_det.model, get_loss("mse"), get_optimizer("sgd"),
            device="cpu")
        serve_a, arrays = detect_serve_leg(det, cpu_det, DETECT_ROOT, smi)
        train_b = detect_train_leg(det, cpu_det, arrays, seed + 72)
        del det, cpu_det
        collect()
        classify_c = detect_classifier_leg(seed + 73, DETECT_ROOT)
        codec_d = detect_codec_leg(written, seed + 72)
    finally:
        shutil.rmtree(DETECT_ROOT, ignore_errors=True)
    launches = _kernels.LAUNCHES.snapshot()
    if launches:
        raise AssertionError(f"the detect phase launched hand-written "
                             f"kernels {launches}")
    return dict(card=smi, detector=dict(
        model="ObjectDetector(class_num=21, ssd-300, base_channels=32)",
        priors=8744), write_s=write_s, leg_a=serve_a, leg_b=train_b,
        leg_c=classify_c, leg_d=codec_d, k1_k5_launches=launches,
        wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------
# layers: the rest of the layer library (the MoE transformer, ConvLSTM2D,
# a BiLSTM-CRF tagger and a sweep of every new layer)
# ---------------------------------------------------------------------------

#: every block's MLP a SparseMoE of 8 experts, top-2, the layer's capacity
#: factor 1.25 (``TransformerLayer(moe_experts=, moe_top_k=)``)
MOE_CONFIG = dict(moe_experts=8, moe_top_k=2)
#: tokens whose top-2 gates clear the next gate (and each other) by this
#: are routed as the CPU routes them
MOE_ROUTE_MARGIN = 1e-2
MOE_TIMED_STEPS = 5
#: Moving MNIST's frame shape: 10 frames of 1 x 64 x 64, the next one
#: predicted
CONVLSTM_BATCH, CONVLSTM_FRAMES, CONVLSTM_SIDE = 16, 10, 64
CONVLSTM_FILTERS, CONVLSTM_STEPS = 64, 4
#: Lample et al. 2016 (NAACL, "Neural Architectures for Named Entity
#: Recognition"): word embeddings of 100, an LSTM of 100 a direction;
#: CoNLL-2003's 9 IOB tags; a seeded surrogate vocabulary of 20,000
NER_VOCAB, NER_EMB, NER_HIDDEN, NER_TAGS = 20000, 100, 100, 9
NER_LEN, NER_BATCH, NER_STEPS = 64, 32, 4
#: Viterbi paths whose best score beats the second best by this equal
#: the CPU's
NER_MARGIN = 1e-3
#: the sweep: (forward, of the output's scale; gradients, of their norm)
LAYER_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 5e-2)}

#: backward nodes of the MoE's ops -> their device-time group
MOE_BACKWARD = {"BaddbmmBackward0": "expert products",
                "GeluBackward0": "expert products",
                "IndexSelectBackward0": "gather/scatter",
                "IndexAddBackward0": "gather/scatter",
                "SortBackward0": "router", "SoftmaxBackward0": "router",
                "CumsumBackward0": "router"}
MOE_SCOPES = {"moe/router": "router", "moe/dispatch": "gather/scatter",
              "moe/experts": "expert products",
              "moe/combine": "gather/scatter"}
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def moe_split(prof):
    """Device ms of a profiled step by part: the MoE's router, gather/
    scatter and expert products (by the ``moe/*`` scope or backward node
    above the op that launched each kernel), the attention and layer-norm
    kernels (K1-K5) and the rest by kernel name. None where the
    profiler's events hold no kernels."""
    out, total = {}, 0.0
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if not kernels:
            continue
        part, node = None, evt
        while node is not None and part is None:
            name = getattr(node, "name", "")
            if name in MOE_SCOPES:
                part = MOE_SCOPES[name]
            elif name.startswith(BACKWARD_NODE):
                part = MOE_BACKWARD.get(name[len(BACKWARD_NODE):], "")
            node = getattr(node, "cpu_parent", None)
        for k in kernels:
            group = part or kernel_group(getattr(k, "name", ""))
            if "port kernel" in group:
                group = ("attention (K1-K3)" if "flash" in group
                         else "layer-norm sites (K4-K5)")
            out[group] = out.get(group, 0.0) + k.duration / 1e3
            total += k.duration / 1e3
    if total == 0.0:
        return None
    return dict(device_ms=total, groups=dict(sorted(
        out.items(), key=lambda kv: -kv[1])))


class RouteRecorder:
    """Wraps a ``SparseMoE``'s ``route`` for the calls of one step: each
    call's input rows and gates, as the card computed them."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []
        self.route = moe.route
        moe.route = self

    def __call__(self, p, flat, generator=None, training=False):
        gates = self.route(p, flat, generator, training)
        self.calls.append((flat.detach(), gates.detach()))
        return gates

    def close(self):
        del self.moe.route


def moe_classifier(seed, dropout):
    config = dict(BERT_CONFIG, hidden_p_drop=dropout, attn_p_drop=dropout,
                  **MOE_CONFIG)
    return build_classifier(seed, config), config


def check_moe_routing(calls, router_ws, cap):
    """Each block's routing on the card against the CPU's from the same
    bf16 rows and router weights: every token whose top-2 gates clear
    the next gate and each other by MOE_ROUTE_MARGIN (on the CPU) goes
    to the same experts in the same order; the drops recounted from the
    card's routing. Returns (tokens held, drops, assignments)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import moe as lmoe
    held = dropped = total = 0
    for i, ((flat, gates), w) in enumerate(zip(calls, router_ws)):
        _, card_top = lmoe.top_k_gates(gates, 2)
        _, kept = lmoe.assign_slots(card_top, MOE_CONFIG["moe_experts"], cap)
        dropped += int(kept.numel() - kept.sum())
        total += kept.numel()
        flat_cpu = flat.cpu()
        cpu = torch.softmax(torch.matmul(flat_cpu, w.to(flat_cpu.dtype))
                            .float(), dim=-1)
        g, cpu_top = torch.sort(cpu, dim=-1, descending=True, stable=True)
        margin = torch.minimum(g[:, 0] - g[:, 1], g[:, 1] - g[:, 2])
        clear = margin > MOE_ROUTE_MARGIN
        bad = (card_top.cpu()[clear] != cpu_top[clear, :2]).any(-1)
        if bad.any():
            raise AssertionError(
                f"block {i}: {int(bad.sum())} of {int(clear.sum())} clear "
                "tokens routed apart from the CPU")
        held += int(clear.sum())
    return held, dropped, total


def moe_leg(seed, dev, smi):
    """Leg A: MoE BERT-base (bench.py's classifier, each block's MLP a
    SparseMoE of 8 experts, top-2) through ``fit`` in bf16 at 32 x 512,
    dropout 0.1, Adam 1e-4, 8 steps; the first step's routing held
    against the CPU and its drops against the counter; a float32
    dropout-off step against the CPU; the step timed and profiled."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import moe as lmoe
    t0 = time.perf_counter()
    model, config = moe_classifier(seed, TRAIN_P_DROP)
    build_s = time.perf_counter() - t0
    bert = next(l for l in model.graph_function().layers
                if isinstance(l, L.BERT))
    n_params = sum(p.numel() for p in model.parameters())
    expert_params = sum(p.numel() for n, p in model.named_parameters()
                        if ".moe.w_" in n or ".moe.b_" in n)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy")
    model.set_compute_dtype("bfloat16")
    x, y, real_tokens = train_data(seed, TRAIN_BATCH, config=config,
                                   ids=np.int32)
    n_tok = x[0].size
    cap = lmoe.capacity(n_tok, 2, MOE_CONFIG["moe_experts"],
                        bert._moe.capacity_factor)
    router_ws = [getattr(bert, f"block{i}")["moe"]["router_w"].detach()
                 .clone().to(torch.bfloat16)
                 for i in range(BERT_CONFIG["n_block"])]
    counter = telemetry.counter("zoo_moe_dropped_tokens_total",
                                layer=bert._moe.name)
    before = counter.value
    recorder = RouteRecorder(bert._moe)
    telemetry.set_enabled(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    finally:
        telemetry.set_enabled(False)
        recorder.close()
    losses = list(model.trainer.step_losses)
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses += model.trainer.step_losses
    counted = counter.value - before
    n_block = BERT_CONFIG["n_block"]
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"MoE launches {launches}, expected {expected}")
    if len(recorder.calls) != n_block:
        raise AssertionError(f"{len(recorder.calls)} MoE calls in a step")
    held, dropped, assigned = check_moe_routing(
        recorder.calls, [w.cpu() for w in router_ws], cap)
    del recorder
    if counted != dropped:
        raise AssertionError(f"drop counter {counted}, recount {dropped}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or \
            not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"MoE losses {losses}")
    check_float32_state(model)
    # the step, timed and profiled on the trained model
    trainer = model.trainer
    batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
    step_s = []
    for _ in range(MOE_TIMED_STEPS):
        s0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
    p50 = percentile(step_s, 50)
    profile = profile_device(lambda: trainer.train_step(batch),
                             split=moe_split)
    timing = dict(step_ms=[1e3 * s for s in step_s], step_p50_ms=1e3 * p50,
                  padded_tokens_per_s=n_tok / p50,
                  real_tokens_per_s=real_tokens / p50,
                  clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                    "temperature.gpu"),
                  profile=profile)
    del model, trainer, batch
    collect()
    parity = check_train_parity(seed + 80, dev, extra=MOE_CONFIG)
    collect()
    return dict(
        model="BERT-base classifier (bench.py:353-438), every block's MLP "
              "a SparseMoE", config=config, capacity=cap,
        parameters=n_params, expert_parameters=expert_params,
        compute_dtype="bfloat16", ids="int32", batch=TRAIN_BATCH,
        steps=TRAIN_STEPS, optimizer=f"adam lr {TRAIN_LR}", build_s=build_s,
        losses=losses, launches=launches, launches_per_step=per_step,
        fit_wall_s=fit_s, peak_memory_bytes=peak,
        routing=dict(tokens_held=held, margin=MOE_ROUTE_MARGIN,
                     assignments=assigned, dropped=dropped,
                     dropped_share=dropped / assigned,
                     counter=counted),
        timing=timing, float32_parity=parity), launches


def moving_frames(seed, n):
    """n sequences of CONVLSTM_FRAMES + 1 frames (1 x 64 x 64): an 8 x 8
    square moving at a seeded velocity, bouncing off the edges; the
    first CONVLSTM_FRAMES are the input, the last the target."""
    rs = np.random.default_rng(seed)
    side, size = CONVLSTM_SIDE, 8
    frames = np.zeros((n, CONVLSTM_FRAMES + 1, 1, side, side), np.float32)
    for i in range(n):
        pos = rs.uniform(0, side - size, 2)
        vel = rs.uniform(-4, 4, 2)
        for t in range(CONVLSTM_FRAMES + 1):
            r, c = pos.astype(int)
            frames[i, t, 0, r:r + size, c:c + size] = 1.0
            pos = pos + vel
            for d in range(2):
                if not 0 <= pos[d] <= side - size:
                    vel[d] = -vel[d]
                    pos[d] = np.clip(pos[d], 0, side - size)
    return frames[:, :-1], frames[:, -1]


def convlstm_model(seed):
    m = Sequential(seed=seed)
    m.add(L.ConvLSTM2D(CONVLSTM_FILTERS, 3, return_sequences=True,
                       input_shape=(CONVLSTM_FRAMES, 1, CONVLSTM_SIDE,
                                    CONVLSTM_SIDE)))
    m.add(L.ConvLSTM2D(CONVLSTM_FILTERS, 3))
    m.add(L.Convolution2D(1, 3, 3, border_mode="same",
                          activation="sigmoid"))
    return m


def first_step_parity(model, x, y, loss, dtype, dev):
    """One step of ``model`` (built, not trained) on PARITY_ROWS rows in
    ``dtype`` on the card against a CPU copy's: the loss's and every
    gradient's gap, within TRAIN_LOSS_TOL / TRAIN_GRAD_TOL in float32 and
    BF16_LOSS_TOL / BF16_GRAD_TOL in bf16."""
    bf16 = dtype == "bfloat16"
    loss_tol, grad_tol = (BF16_LOSS_TOL, BF16_GRAD_TOL) if bf16 else \
        (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)
    model.graph_function()      # a Sequential builds its weights here
    cpu_model = copy.deepcopy(model)
    loss_fn = get_loss(loss)
    card = SPMDTrainer(model, loss_fn, get_optimizer("sgd"), device=dev,
                       compute_dtype=dtype)
    cpu = SPMDTrainer(cpu_model, loss_fn, get_optimizer("sgd"),
                      device="cpu", compute_dtype=dtype)
    batch = (x if isinstance(x, list) else [x], y,
             np.ones(len(y), np.float32))
    card.ensure_initialized()
    cpu.ensure_initialized()
    card_loss = card.loss_and_grads(card.put_batch(batch)).item()
    t0 = time.perf_counter()
    cpu_loss = cpu.loss_and_grads(cpu.put_batch(batch)).item()
    cpu_s = time.perf_counter() - t0
    cpu_params = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        g, w = p.grad.cpu(), cpu_params[name].grad
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient on the card")
        rel = _rel(g, w)
        if rel > worst:
            worst, worst_name = rel, name
    res = dict(rows=len(y), compute_dtype=dtype, card_loss=card_loss,
               cpu_loss=cpu_loss, loss_err=abs(card_loss - cpu_loss),
               loss_tol=loss_tol, max_grad_rel_err=worst,
               max_grad_rel_err_param=worst_name, grad_tol=grad_tol,
               cpu_step_s=cpu_s)
    if res["loss_err"] > loss_tol or worst > grad_tol:
        raise AssertionError(f"first step off the CPU's: {res}")
    return res


def convlstm_leg(seed, dev):
    """Leg B: two ConvLSTM2D(64, 3) over 10 frames of 1 x 64 x 64 and a
    sigmoid convolution predicting the next frame, batch 16, Adam, mse;
    in float32 and bf16: the first step on PARITY_ROWS rows against the
    CPU, then 4 falling ``fit`` steps."""
    x, y = moving_frames(seed, CONVLSTM_BATCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        parity = first_step_parity(convlstm_model(seed + 1),
                                   x[:PARITY_ROWS], y[:PARITY_ROWS], "mse",
                                   dtype, dev)
        model = convlstm_model(seed + 1)
        model.compile(optimizer=Adam(lr=1e-3), loss="mse")
        model.set_compute_dtype(dtype)
        fit = fit_one_batch(f"ConvLSTM2D {dtype}", model, x, y,
                            CONVLSTM_BATCH, CONVLSTM_STEPS)
        trainer = model.trainer
        batch = trainer.put_batch(([x], y, np.ones(CONVLSTM_BATCH,
                                                   np.float32)))
        step_s = []
        for _ in range(3):
            s0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - s0)
        out[dtype] = dict(first_step=parity, fit=fit,
                          step_p50_ms=1e3 * percentile(step_s, 50))
        del model, trainer, batch
        collect()
    return dict(model="ConvLSTM2D(64, 3, return_sequences) -> "
                      "ConvLSTM2D(64, 3) -> Convolution2D(1, 3, 3, sigmoid)",
                input=[CONVLSTM_BATCH, CONVLSTM_FRAMES, 1, CONVLSTM_SIDE,
                       CONVLSTM_SIDE], steps=CONVLSTM_STEPS, **out)


def token_mask(words):
    """The CRF's mask: real tokens (ids above 0) before the padded
    tail."""
    return (words > 0).float()


def ner_model(seed):
    from analytics_zoo_tpu_torch.pipeline.api.autograd import Lambda
    words = L.Input(shape=(NER_LEN,), name="words")
    h = L.Embedding(NER_VOCAB, NER_EMB)(words)
    h = L.Bidirectional(L.LSTM(NER_HIDDEN, return_sequences=True))(h)
    h = L.TimeDistributed(L.Dense(NER_TAGS))(h)
    unary, trans = L.CRF(NER_TAGS)(h)
    mask = Lambda(token_mask)(words)
    return Model(words, [unary, trans, mask], seed=seed)


def ner_data(seed, n):
    rs = np.random.default_rng(seed)
    lengths = rs.integers(8, NER_LEN + 1, n)
    words = rs.integers(1, NER_VOCAB, (n, NER_LEN))
    real = np.arange(NER_LEN)[None] < lengths[:, None]
    words = np.where(real, words, 0)
    tags = np.where(real, words % NER_TAGS, 0)
    return words.astype(np.float32), tags.astype(np.float32)


def viterbi_margins(unary, trans, mask):
    """Each sequence's best path score less the second best, in float64:
    the best score through (t, j) is the forward max plus the backward
    max, and the second-best path leaves the best one somewhere."""
    u = unary.double()
    tr = trans.double()
    m = mask.bool()
    b, l, e = u.shape
    fwd = [u[:, 0]]
    for t in range(1, l):
        new = (fwd[-1][:, :, None] + tr[None]).amax(1) + u[:, t]
        fwd.append(torch.where(m[:, t, None], new, fwd[-1]))
    bwd = [torch.zeros(b, e, dtype=torch.float64)]
    for t in range(l - 2, -1, -1):
        new = (tr[None] + (u[:, t + 1] + bwd[0])[:, None, :]).amax(2)
        bwd.insert(0, torch.where(m[:, t + 1, None], new, bwd[0]))
    through = torch.stack([f + g for f, g in zip(fwd, bwd)], 1)  # (B,L,E)
    best = through.amax(-1)[:, 0]
    top = torch.topk(through, 2, dim=-1).values
    second = torch.where(m, top[..., 1], torch.full_like(top[..., 1],
                                                         -np.inf))
    return best - second.amax(-1)


def ner_leg(seed, dev):
    """Leg C: a BiLSTM-CRF tagger at Lample et al.'s widths through
    ``fit`` (``CRFLoss`` with the token mask) for 4 falling steps at
    batch 32 x 64; its Viterbi paths on the card (``ops/crf.py`` on card
    tensors) against the CPU's where the best path clears the second."""
    from analytics_zoo_tpu_torch.ops import crf as crf_ops
    x, y = ner_data(seed, NER_BATCH)
    model = ner_model(seed + 1)
    model.compile(optimizer=Adam(lr=1e-2), loss="crf")
    fit = fit_one_batch("BiLSTM-CRF", model, x, y, NER_BATCH, NER_STEPS)
    unary, trans, mask = model.predict(x, batch_size=NER_BATCH)
    cpu = cpu_twin(model)
    cunary, ctrans, cmask = cpu.trainer.predict(x, batch_size=NER_BATCH)
    dev_tags, _ = crf_ops.crf_decode(torch.as_tensor(unary, device=dev),
                                     torch.as_tensor(trans[0], device=dev),
                                     torch.as_tensor(mask, device=dev))
    cpu_tags, _ = crf_ops.crf_decode(torch.as_tensor(cunary),
                                     torch.as_tensor(ctrans[0]),
                                     torch.as_tensor(cmask))
    margins = viterbi_margins(torch.as_tensor(cunary),
                              torch.as_tensor(ctrans[0]),
                              torch.as_tensor(cmask))
    clear = margins > NER_MARGIN
    real = torch.as_tensor(cmask).bool()
    same = ((dev_tags.cpu() == cpu_tags) | ~real).all(-1)
    if not same[clear].all() or not clear.any():
        raise AssertionError(f"Viterbi paths off the CPU's: {int(clear.sum())}"
                             f" clear, {int((~same[clear]).sum())} differ")
    unary_err = float(np.abs(unary - cunary).max())
    del model, cpu
    collect()
    return dict(model=f"Embedding({NER_VOCAB}, {NER_EMB}) -> "
                      f"Bidirectional(LSTM({NER_HIDDEN})) -> "
                      f"TimeDistributed(Dense({NER_TAGS})) -> "
                      f"CRF({NER_TAGS}), CRFLoss with the token mask",
                batch=NER_BATCH, max_len=NER_LEN, fit=fit,
                unary_max_abs_err=unary_err, paths_clear=int(clear.sum()),
                paths_equal=int(same.sum()), margin=NER_MARGIN)


#: (name, layer maker, input shape less the batch, checked in bf16)
LAYER_SWEEP = [
    ("LeakyReLU", lambda: L.LeakyReLU(0.2), (3, 5), True),
    ("ELU", lambda: L.ELU(0.7), (3, 5), True),
    ("PReLU", lambda: L.PReLU(n_output_plane=3), (3, 4, 2), True),
    ("SReLU", lambda: L.SReLU(shared_axes=[1]), (3, 4), True),
    ("ThresholdedReLU", lambda: L.ThresholdedReLU(0.3), (3, 5), True),
    ("RReLU", lambda: L.RReLU(0.1, 0.4), (3, 5), True),
    ("Softmax", lambda: L.Softmax(axis=1), (4, 3), True),
    ("Convolution3D", lambda: L.Convolution3D(
        8, 3, 3, 3, border_mode="same", subsample=(2, 1, 2)),
     (4, 9, 10, 11), True),
    ("Convolution3D_tf", lambda: L.Convolution3D(
        6, 2, 3, 2, dim_ordering="tf"), (7, 8, 6, 4), True),
    ("ShareConvolution2D", lambda: L.ShareConvolution2D(
        8, 3, 3, border_mode="same"), (4, 12, 10), True),
    ("LocallyConnected2D", lambda: L.LocallyConnected2D(
        4, 3, 3, border_mode="same", subsample=(2, 2)), (3, 9, 8), True),
    ("LocallyConnected1D", lambda: L.LocallyConnected1D(
        5, 3, subsample_length=2), (11, 4), True),
    ("Cropping3D", lambda: L.Cropping3D(((1, 0), (0, 1), (1, 1))),
     (2, 4, 4, 5), True),
    ("UpSampling3D", lambda: L.UpSampling3D((1, 2, 3)), (2, 2, 3, 2), True),
    ("ZeroPadding3D", lambda: L.ZeroPadding3D((1, 0, 2)), (2, 2, 3, 2),
     True),
    ("ConvLSTM2D", lambda: L.ConvLSTM2D(4, 3, return_sequences=True,
                                        go_backwards=True),
     (3, 2, 8, 8), True),
    ("ConvLSTM3D", lambda: L.ConvLSTM3D(3, 3, subsample=2),
     (3, 2, 5, 6, 6), True),
    ("CRF", lambda: L.CRF(5), (7, 5), True),
    # routing ties between bf16 and float32 are leg A's margin rule
    ("SparseMoE", lambda: L.SparseMoE(4, 32, top_k=2), (16, 24), False),
] + [(f"Deconvolution2D_s{s}_k{k}_{mode}",
      lambda s=s, k=k, mode=mode: L.Deconvolution2D(
          6, k, k + 1, border_mode=mode, subsample=(s, s)),
      (4, 7, 9), True)
     for s in (1, 2, 3) for k in (2, 3) for mode in ("valid", "same")]


def sweep_layer(name, make, shape, dtype, dev, seed):
    """The layer's forward and backward on the card (TF32 off) against the
    port's CPU run in float32 on the same inputs (bf16: the inputs and
    parameters rounded to bf16 first): the outputs within LAYER_TOL of
    their scale, the input's and parameters' gradients of their norm."""
    gen = torch.Generator().manual_seed(seed)
    layer = make()
    layer.build_params(gen, (None,) + shape)
    with torch.no_grad():   # nonzero biases and thresholds
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    bf16 = dtype == "bfloat16"
    x = torch.randn((4,) + shape, generator=gen)
    if bf16:
        x = x.to(torch.bfloat16).float()
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(p.to(torch.bfloat16).float())
    card_layer = copy.deepcopy(layer).to(dev)

    def run(lay, xx, cast):
        xx = xx.clone().requires_grad_()
        params = {k: v.to(cast) for k, v in lay.named_parameters()}
        out = torch.func.functional_call(lay, params, (xx.to(cast),))
        outs = out if isinstance(out, (list, tuple)) else (out,)
        cots = [torch.randn(o.shape, generator=torch.Generator()
                            .manual_seed(seed + i)).to(o.device)
                for i, o in enumerate(outs)]
        grads = torch.autograd.grad(
            sum((o.float() * c).sum() for o, c in zip(outs, cots)),
            [xx] + list(params.values()), allow_unused=True)
        return [o.detach().float().cpu() for o in outs], \
            [None if g is None else g.float().cpu() for g in grads]

    want, want_g = run(layer, x, torch.float32)
    got, got_g = run(card_layer, x.to(dev),
                     torch.bfloat16 if bf16 else torch.float32)
    fwd_tol, grad_tol = LAYER_TOL[dtype]
    fwd_err = max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
                  for g, w in zip(got, want))
    grad_err = max((_rel(g, w) for g, w in zip(got_g, want_g)
                    if w is not None and float(w.norm()) > 0), default=0.0)
    if fwd_err > fwd_tol or grad_err > grad_tol or \
            not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{name} ({dtype}) on the card off the CPU: "
                             f"forward {fwd_err}, gradient {grad_err}")
    return dict(forward_err=fwd_err, grad_err=grad_err)


def sweep_leg(seed, dev):
    """Leg D: every new layer forward and backward on the card against
    the CPU, float32 and bf16."""
    out = {}
    for i, (name, make, shape, with_bf16) in enumerate(LAYER_SWEEP):
        for dtype in ("float32", "bfloat16") if with_bf16 else ("float32",):
            out[f"{name}/{dtype}"] = sweep_layer(name, make, shape, dtype,
                                                 dev, seed + i)
    return dict(cases=len(out), tol=LAYER_TOL, results=out,
                worst_forward_err=max(r["forward_err"] for r in
                                      out.values()),
                worst_grad_err=max(r["grad_err"] for r in out.values()))


def layers_phase(seed, dev, smi):
    """The layers phase (see the module docstring): returns the report
    and leg A's K1-K5 launches."""
    t0 = time.perf_counter()
    leg_a, launches = moe_leg(seed + 90, dev, smi)
    a_s = time.perf_counter() - t0
    _kernels.LAUNCHES.reset()
    leg_b = convlstm_leg(seed + 91, dev)
    leg_c = ner_leg(seed + 92, dev)
    leg_d = sweep_leg(seed + 93, dev)
    others = _kernels.LAUNCHES.snapshot()
    if others:
        raise AssertionError(f"legs B-D launched hand-written kernels "
                             f"{others}")
    return dict(card=smi, leg_a=leg_a, leg_a_s=a_s, leg_b=leg_b,
                leg_c=leg_c, leg_d=leg_d, k1_k5_launches_b_to_d=others,
                wall_s=time.perf_counter() - t0), launches


# ---------------------------------------------------------------------------
# parallel: data and sequence parallelism through the launcher
# ---------------------------------------------------------------------------

PAR_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_parallel")
# the script the launcher runs on every rank (this one, in worker mode)
PAR_SCRIPT = os.path.abspath(__file__)
PAR_STEPS, PAR_SAVE_AT = 4, 2          # leg A: bf16 steps, the checkpoint
PAR_B_STEPS = 2                        # leg B: bf16 steps a rank
PAR_C_STEPS = {"ulysses": 2, "ring": 2}
PAR_TIMED_STEPS = 1   # depth: cut from 2 beside the estimators phase
# every leg's classifier: bench.py's BERT-base at full width, its depth cut
# from 12 blocks to 4 (a proof run of the whole script took 1,102 s of its
# 1,200 s limit at 12); 4 divides among 2 or 4 pipe ranks
PAR_BLOCKS = 4
PAR_CONFIG = dict(BERT_CONFIG, n_block=PAR_BLOCKS)
PAR_LAUNCH_TIMEOUT_S = 300.0
# the ranks of legs B and C: two sharing the one card (gloo); on a
# machine with more cards, one a card (NCCL)
PAR_RANKS = PAR_SHARDS
# leg A over NCCL: one rank a card
PAR_A_BACKEND = "nccl"


class AtEpochEnd(ZooTrigger):
    """Fires once: at the end of the epoch whose last iteration is
    ``iteration`` (the checkpoint then holds the next epoch's start)."""

    def __init__(self, iteration):
        self.iteration = iteration

    def __call__(self, record):
        return record.epoch_finished and record.iteration == self.iteration


def par_env():
    """The launcher's environment: TF32 off in every rank (as in the
    script), none of the caller's ZOO_TPU_* variables."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZOO_TPU_")}
    env["NVIDIA_TF32_OVERRIDE"] = "0"
    return env


def par_reports(leg, ranks):
    """Each rank's report of ``leg`` (``PAR_ROOT/<leg>.rank<r>.json``)."""
    reports = []
    for r in range(ranks):
        with open(os.path.join(PAR_ROOT, f"{leg}.rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def par_launch(leg, ranks, seed, env=None):
    """Run the ``leg`` worker on ``ranks`` ranks through ``python -m
    analytics_zoo_tpu_torch.launcher.cli``; returns the launch's wall
    time. The launcher runs in a session of its own, killed whole at the
    time limit."""
    cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher.cli",
           "--hosts", str(ranks), PAR_SCRIPT, "--parallel-worker", leg,
           "--seed", str(seed)]
    full_env = par_env()
    full_env.update(env or {})
    log = os.path.join(PAR_ROOT, f"{leg}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, env=full_env, stdout=f,
                             stderr=subprocess.STDOUT,
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             start_new_session=True)
        try:
            rc = p.wait(timeout=PAR_LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
            rc = "timeout"
    wall = time.perf_counter() - t0
    if rc != 0:
        tail = open(log).read()[-6000:]
        raise AssertionError(f"parallel leg {leg}: launcher rc={rc}\n{tail}")
    return wall


def par_bf16_model(seed):
    """The leg's bf16 classifier: bench.py's BERT-base at full width,
    dropout 0.1, Adam at TRAIN_LR (``train``'s)."""
    config = dict(PAR_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    model = build_classifier(seed + 1, config)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy")
    model.set_compute_dtype("bfloat16")
    return model


def par_f32_model(seed):
    """The float32 gate's classifier, dropout off."""
    model = build_classifier(seed + 2, dict(PAR_CONFIG, hidden_p_drop=0.0,
                                            attn_p_drop=0.0))
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy")
    return model


def par_per_step():
    n = PAR_CONFIG["n_block"]
    return {attn.KERNEL_NAME: n, attn.DQ_KERNEL_NAME: n,
            attn.DKV_KERNEL_NAME: n, dln.FWD_KERNEL_NAME: 2 * n,
            dln.BWD_KERNEL_NAME: 2 * n}


def par_check_launches(what, launches, steps, attention=True):
    """K1-K5 launched as a step of the path runs them, ``steps`` times
    (K1-K3 not at all where ``attention`` is False: the ring)."""
    want = {k: steps * v for k, v in par_per_step().items()
            if attention or k in (dln.FWD_KERNEL_NAME, dln.BWD_KERNEL_NAME)}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def par_reference(seed, dev):
    """The in-process references: the bf16 fit of leg A (losses, the
    Adam moments' bytes) and the float32 gate's step (loss and every
    gradient, saved for the ranks)."""
    model = par_bf16_model(seed)
    x, y, _ = train_data(seed, TRAIN_BATCH, ids=np.int32)
    _kernels.LAUNCHES.reset()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=PAR_STEPS)
    par_check_launches("in-process bf16 fit", _kernels.LAUNCHES.snapshot(),
                       PAR_STEPS)
    ref = dict(losses=list(model.trainer.step_losses),
               moment_bytes=zero.per_rank_bytes(model.trainer.opt_state))
    del model
    collect()
    model = par_f32_model(seed)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    x, y, _ = train_data(seed + 2, TRAIN_BATCH)
    loss = trainer.loss_and_grads(trainer.put_batch(
        (x, y, np.ones(TRAIN_BATCH, np.float32))))
    # in parameter order: the ranks' models carry other layer names
    grads = [p.grad.detach().cpu() for p in model.parameters()]
    ref["f32_loss"] = float(loss)
    torch.save({"loss": ref["f32_loss"], "grads": grads},
               os.path.join(PAR_ROOT, "f32_step.pt"))
    del model, trainer, grads
    collect()
    return ref


def par_gate(trainer, seed):
    """The float32 gate on this rank: one step's loss and gradients
    summed over the ranks (under ZeRO-1 this rank's block of each)
    against the in-process step's, each gradient's error over the
    reference gradient's norm (``check_train_parity``'s measure)."""
    ref = torch.load(os.path.join(PAR_ROOT, "f32_step.pt"))
    x, y, _ = train_data(seed + 2, TRAIN_BATCH)
    batch = trainer.put_batch(trainer._rank_block(
        MiniBatch(tuple(x), y, np.ones(TRAIN_BATCH, np.float32))))
    loss, grads = trainer.summed_grads(batch)
    worst, worst_name = 0.0, None
    rank = trainer.mesh.index("data")
    for name, full in zip(trainer.params(), ref["grads"]):
        want = trainer._zero_layout.own_block(full, name, rank) \
            if trainer.zero_mode() == "flat" else full
        g = grads[name].float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient")
        rel = ((g - want).norm() / max(full.norm().item(), 1e-12)).item()
        if rel > worst:
            worst, worst_name = rel, name
    loss_err = abs(float(loss) - ref["loss"])
    res = dict(rows=TRAIN_BATCH, dropout=0.0, compute_dtype="float32",
               loss=float(loss), in_process_loss=ref["loss"],
               loss_err=loss_err, loss_tol=TRAIN_LOSS_TOL,
               max_grad_rel_err=worst, max_grad_rel_err_param=worst_name,
               grad_tol=TRAIN_GRAD_TOL, zero_blocks=trainer.zero_mode())
    if loss_err > TRAIN_LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"float32 gate: {res}")
    return res


def collective_split(prof):
    """Each collective kind's time over a profile: the host time of its
    ``zoo_collective/<kind>`` ranges (``parallel/collectives.py``; a gloo
    collective is synchronous, so its range is its time; an NCCL one's is
    its launch), and the NCCL kernels' device time."""
    out = {}
    for evt in prof.key_averages():
        if evt.key.startswith("zoo_collective/") and \
                evt.device_type == torch.autograd.DeviceType.CPU:
            out[evt.key.split("/", 1)[1]] = dict(
                host_ms=evt.cpu_time_total / 1e3, calls=evt.count)
        elif "nccl" in evt.key.lower() and \
                evt.device_type == torch.autograd.DeviceType.CUDA:
            g = out.setdefault("nccl_device", dict(device_ms=0.0, calls=0))
            g["device_ms"] += evt.self_device_time_total / 1e3
            g["calls"] += evt.count
    return out


def par_timed(trainer, x, y, profile=True):
    """PAR_TIMED_STEPS steps on this rank's block of one batch: the step
    times (host clock to a synchronize), then (``profile``) one more
    step under the profiler, its collective time by kind."""
    batch = trainer.put_batch(trainer._rank_block(
        MiniBatch(tuple(x), y, np.ones(len(y), np.float32))))
    times = []
    for _ in range(PAR_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out = dict(step_ms=times, step_p50_ms=float(np.median(times)))
    if profile:
        prof = profile_device(lambda: trainer.train_step(batch),
                              split=collective_split)
        out.update(collectives_per_step=prof.pop("split"), profile=prof)
    return out


def par_worker_report(ctx, leg, **fields):
    """Write this rank's report of ``leg`` (the fields over the rank's
    context, peak memory and collectives made)."""
    report = dict(rank=ctx.process_index, world=ctx.num_processes,
                  backend=ctx.backend, mesh=ctx.mesh.shape,
                  device=str(ctx.device),
                  peak_memory_bytes=torch.cuda.max_memory_allocated(),
                  gloo_host_routed_kinds=sorted(
                      par_collectives.GLOO_HOST_ROUTED)
                  if ctx.backend == "gloo" else [],
                  collective_calls=par_collectives.CALLS.snapshot())
    report.update(fields)
    path = os.path.join(PAR_ROOT, f"{leg}.rank{ctx.process_index}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def par_worker_a(seed, resume):
    """Leg A on one rank over NCCL: the bf16 fit with a sharded
    checkpoint at step PAR_SAVE_AT, or (``resume``) steps PAR_SAVE_AT+1 to
    PAR_STEPS from it."""
    t0 = time.perf_counter()
    ctx = init_nncontext()
    if ctx.backend != PAR_A_BACKEND or ctx.num_processes != 1:
        raise AssertionError(f"leg A: backend {ctx.backend}, world "
                             f"{ctx.num_processes}")
    model = par_bf16_model(seed)
    x, y, _ = train_data(seed, TRAIN_BATCH, ids=np.int32)
    ckpt = os.path.join(PAR_ROOT, "a_ckpt")
    trainer = model._ensure_trainer()
    seconds = dict(init_and_build=time.perf_counter() - t0)
    if resume:
        t1 = time.perf_counter()
        trainer.load_checkpoint(ckpt)
        seconds["load"] = time.perf_counter() - t1
        if trainer.step != PAR_SAVE_AT:
            raise AssertionError(f"resumed at step {trainer.step}")
    else:
        model.set_checkpoint(ckpt, trigger=AtEpochEnd(PAR_SAVE_AT))
    steps = PAR_STEPS - trainer.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    par_check_launches("leg A", launches, steps)
    seconds["fit"] = wall
    fields = dict(losses=list(model.trainer.step_losses), launches=launches,
                  steps=steps, seconds=seconds,
                  moment_bytes=zero.per_rank_bytes(trainer.opt_state))
    if not resume:
        fields["checkpoint"] = sorted(os.listdir(ckpt))
        t1 = time.perf_counter()
        # one rank makes no collective call (collective_calls stays empty):
        # nothing for the profiler to time
        fields["timing"] = par_timed(trainer, x, y, profile=False)
        seconds["timed"] = time.perf_counter() - t1
    par_worker_report(ctx, "a_resume" if resume else "a", **fields)


def par_bf16_fit(what, model, x, y, steps, attention=True):
    """``steps`` bf16 ``fit`` steps from the counters at 0: the losses,
    K1-K5's launches (checked) and the collective calls made."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    par_collectives.CALLS.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=steps)
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES.snapshot()
    par_check_launches(what, launches, steps, attention)
    losses = list(model.trainer.step_losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what}: losses {losses}")
    return dict(losses=losses, launches=launches,
                fit_collective_calls=par_collectives.CALLS.snapshot(),
                fit_s=time.perf_counter() - t0)


def par_leg_b(seed):
    """Leg B on this rank (data_parallel = the world, ZeRO-1): the
    float32 gate, PAR_B_STEPS bf16 steps at B = 32 / dp a rank, the
    timed steps."""
    t0 = time.perf_counter()
    model = par_f32_model(seed)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    gate = par_gate(trainer, seed)
    del model, trainer
    collect()
    t1 = time.perf_counter()
    model = par_bf16_model(seed)
    x, y, _ = train_data(seed, TRAIN_BATCH, ids=np.int32)
    fit = par_bf16_fit("leg B", model, x, y, PAR_B_STEPS)
    trainer = model.trainer
    if trainer.zero_mode() != "flat":
        raise AssertionError(f"leg B: ZeRO mode {trainer.zero_mode()}")
    zero.assert_zero_collectives(fit["fit_collective_calls"],
                                 sum(p.numel() for p in model.parameters()))
    out = dict(gate=gate,
               batch_per_rank=TRAIN_BATCH // trainer.world_size(),
               zero_mode=trainer.zero_mode(),
               moment_bytes=zero.per_rank_bytes(trainer.opt_state),
               peak_memory_bytes=torch.cuda.max_memory_allocated(), **fit)
    t2 = time.perf_counter()
    out["timing"] = par_timed(trainer, x, y)
    out["seconds"] = dict(gate=t1 - t0, fit=t2 - t1,
                          timed=time.perf_counter() - t2)
    return out


def par_leg_c(seed):
    """Leg C on this rank (sequence_parallel = the world): the float32
    gate in each
    mode on one float32 model, then in Ulysses mode and then in ring
    mode PAR_C_STEPS[mode] bf16 steps of a fresh model (the same weights)
    and the timed steps."""
    config = zoo_nncontext.get_nncontext().config
    t0 = time.perf_counter()
    model = par_f32_model(seed)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    modes = {}
    for mode in ("ulysses", "ring"):
        config.sequence_parallel_mode = mode
        modes[mode] = dict(gate=par_gate(trainer, seed))
    del model, trainer
    collect()
    seconds = dict(gates=time.perf_counter() - t0)
    x, y, _ = train_data(seed, TRAIN_BATCH, ids=np.int32)
    for mode in ("ulysses", "ring"):
        config.sequence_parallel_mode = mode
        t1 = time.perf_counter()
        model = par_bf16_model(seed)
        modes[mode].update(par_bf16_fit(f"leg C {mode}", model, x, y,
                                        PAR_C_STEPS[mode],
                                        attention=mode == "ulysses"))
        modes[mode]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        modes[mode]["timing"] = par_timed(model.trainer, x, y)
        seconds[mode] = time.perf_counter() - t1
        del model
        collect()
    modes["ulysses"]["k1_shape"] = [
        TRAIN_BATCH, PAR_CONFIG["seq_len"],
        PAR_CONFIG["n_head"] // zoo_nncontext.get_nncontext().num_processes,
        PAR_CONFIG["hidden_size"] // PAR_CONFIG["n_head"]]
    return dict(modes=modes, seconds=seconds)


def par_worker_bc(seed):
    """Legs B to G on the launch's ranks (two sharing the card over
    gloo, or one a card over NCCL), one launch: leg B's context, then leg
    C's and legs D-G's over the same process group."""
    world = int(os.environ["ZOO_TPU_NUM_PROCESSES"])
    ctx = init_nncontext(zoo_nncontext.ZooConfig(data_parallel=world,
                                                 zero_stage=1))
    b = par_leg_b(seed)
    par_worker_report(ctx, "b", **b)
    zoo_nncontext.set_nncontext(None)
    ctx = init_nncontext(zoo_nncontext.ZooConfig(data_parallel=1,
                                                 sequence_parallel=world))
    par_worker_report(ctx, "c", **par_leg_c(seed))
    par_worker_layout(seed)


# ---------------------------------------------------------------------------
# the parallel phase's layout legs D-G: tensor, pipeline and expert
# parallelism and FSDP with ZeRO-1's gspmd mode, two ranks sharing the card
# (or one a card over NCCL on a machine with as many cards)
# ---------------------------------------------------------------------------

PAR_LAYOUT_STEPS = 2
PAR_LAYOUT_LEGS = ("d", "e", "f", "g")


def par_layout_config(leg, world):
    """The leg's ZooConfig fields over ``world`` ranks: D tensor, E
    pipeline (M = PAR_PIPE_MICRO), F expert parallelism (the MoE
    BERT-base), G FSDP with ZeRO-1 (gspmd)."""
    return {"d": dict(data_parallel=1, model_parallel=world),
            "e": dict(data_parallel=1, pipeline_parallel=world,
                      pipeline_microbatches=PAR_PIPE_MICRO),
            "f": dict(data_parallel=1, expert_parallel=world),
            "g": dict(data_parallel=world, param_sharding="fsdp",
                      zero_stage=1)}[leg]


def par_layout_model(seed, leg):
    """The leg's classifier at BERT-base width (leg F's with PR 16's 8
    experts, top 2), dropout off, Adam at TRAIN_LR, float32; the same
    weights in every rank and in the in-process reference (drawn from the
    seed on the CPU, in the same order in the stacked layout)."""
    config = dict(PAR_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0,
                  **(MOE_CONFIG if leg == "f" else {}))
    model = build_classifier(seed + 5, config)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy")
    return model


def par_layout_per_step(leg, world):
    """K1-K5 launched a step on a rank: the PAR_BLOCKS blocks' (a pipe
    rank's n_block / S blocks once a microbatch)."""
    n = PAR_CONFIG["n_block"]
    if leg == "e":
        n = n // world * PAR_PIPE_MICRO
    return {attn.KERNEL_NAME: n, attn.DQ_KERNEL_NAME: n,
            attn.DKV_KERNEL_NAME: n, dln.FWD_KERNEL_NAME: 2 * n,
            dln.BWD_KERNEL_NAME: 2 * n}


def par_rel_name(model, name):
    """A parameter's name with its layer's position in the graph in
    place of the layer's name (the ranks' models number layers apart)."""
    layer, _, rest = name.partition(".")
    names = [l.name for l in model.graph_function().layers]
    return f"{names.index(layer)}:{rest}"


def par_layout_reference(seed):
    """The in-process float32 steps the legs' gates hold each rank to:
    the dense and the MoE classifier's loss and every gradient of one
    step on PAR_LAYOUT_BATCH rows, dropout off, saved for the ranks."""
    x, y, _ = train_data(seed + 3, PAR_LAYOUT_BATCH)
    out = {}
    for kind, leg in (("dense", "d"), ("moe", "f")):
        model = par_layout_model(seed, leg)
        trainer = model._ensure_trainer()
        trainer.ensure_initialized()
        loss = trainer.loss_and_grads(trainer.put_batch(
            (x, y, np.ones(PAR_LAYOUT_BATCH, np.float32))))
        grads = {par_rel_name(model, n): p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
        out[kind] = dict(loss=float(loss), moment_bytes=zero.per_rank_bytes(
            trainer.opt_state))
        torch.save({"loss": float(loss), "grads": grads},
                   os.path.join(PAR_ROOT, f"layout_{kind}.pt"))
        del model, trainer, grads
        collect()
    return out


def par_layout_want(trainer, name, rel, grads):
    """The reference gradient of parameter ``name`` as this rank holds
    it: the stacked layout's blocks stacked, then the rank's block of the
    leaf, then under gspmd its data block."""
    m = re.fullmatch(r"(\d+):blocks\.(.+)", rel)
    if m:
        full = torch.stack([grads[f"{m.group(1)}:block{i}.{m.group(2)}"]
                            for i in range(PAR_CONFIG["n_block"])])
    else:
        full = grads[rel]
    want = full
    shard = trainer.shards.get(name)
    if shard is not None:
        want = shard.block_of(full)
    dims = trainer._zero_dims
    if dims is not None and name in dims.dims:
        want = dims.own(want, name, trainer.mesh.index("data"))
    return full, want


def par_layout_gate(trainer, seed, kind):
    """The float32 gate on this rank: one step's loss and its gradient
    blocks against the in-process step's, each block's error over the
    whole reference gradient's norm (``par_gate``'s measure)."""
    ref = torch.load(os.path.join(PAR_ROOT, f"layout_{kind}.pt"))
    x, y, _ = train_data(seed + 3, PAR_LAYOUT_BATCH)
    batch = trainer.put_batch(trainer._rank_block(
        MiniBatch(tuple(x), y, np.ones(PAR_LAYOUT_BATCH, np.float32))))
    loss, grads = trainer.summed_grads(batch)
    worst, worst_name = 0.0, None
    for name, g in grads.items():
        full, want = par_layout_want(trainer, name,
                                     par_rel_name(trainer.model, name),
                                     ref["grads"])
        g = g.float().cpu()
        if tuple(g.shape) != tuple(want.shape):
            raise AssertionError(f"{name}: block {tuple(g.shape)}, "
                                 f"expected {tuple(want.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient")
        rel = ((g - want).norm() / max(full.norm().item(), 1e-12)).item()
        if rel > worst:
            worst, worst_name = rel, name
    loss_err = abs(float(loss) - ref["loss"])
    res = dict(rows=PAR_LAYOUT_BATCH, dropout=0.0, compute_dtype="float32",
               loss=float(loss), in_process_loss=ref["loss"],
               loss_err=loss_err, loss_tol=TRAIN_LOSS_TOL,
               max_grad_rel_err=worst, max_grad_rel_err_param=worst_name,
               grad_tol=TRAIN_GRAD_TOL, zero_mode=trainer.zero_mode(),
               cut_leaves=len(trainer.shards))
    if loss_err > TRAIN_LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"float32 gate: {res}")
    return res


def par_layout_leg(leg, seed, world):
    """One layout leg on this rank: its context, the float32 gate, then
    PAR_LAYOUT_STEPS bf16 steps (dropout 0.1) with K1-K5's launches
    checked, the memory a rank and the timed steps with their
    collectives by kind."""
    zoo_nncontext.set_nncontext(None)
    ctx = init_nncontext(zoo_nncontext.ZooConfig(
        **par_layout_config(leg, world)))
    kind = "moe" if leg == "f" else "dense"
    t0 = time.perf_counter()
    model = par_layout_model(seed, leg)
    trainer = model._ensure_trainer()
    trainer.ensure_initialized()
    gate = par_layout_gate(trainer, seed, kind)
    # the gate moved no weight: the bf16 fit starts from the same ones, on
    # a new trainer (a new Adam state) over the layout already cut, with
    # dropout on
    bert = next(l for l in model.graph_function().layers
                if isinstance(l, L.BERT))
    bert.hidden_p_drop = bert.attn_p_drop = TRAIN_P_DROP
    model.set_compute_dtype("bfloat16")
    del trainer
    collect()
    t1 = time.perf_counter()
    x, y, _ = train_data(seed, PAR_LAYOUT_BATCH, ids=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    par_collectives.CALLS.reset()
    model.fit(x, y, batch_size=PAR_LAYOUT_BATCH, nb_epoch=PAR_LAYOUT_STEPS)
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES.snapshot()
    want = {k: PAR_LAYOUT_STEPS * v
            for k, v in par_layout_per_step(leg, world).items()}
    if launches != want:
        raise AssertionError(f"leg {leg.upper()}: launches {launches}, "
                             f"expected {want}")
    losses = list(model.trainer.step_losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"leg {leg.upper()}: losses {losses}")
    trainer = model.trainer
    params = dict(model.named_parameters())
    cut = [n for n in params if n in trainer.shards]
    out = dict(config=par_layout_config(leg, world), gate=gate,
               losses=losses, launches=launches,
               fit_collective_calls=par_collectives.CALLS.snapshot(),
               fit_peak_memory_bytes=torch.cuda.max_memory_allocated(),
               zero_mode=trainer.zero_mode(),
               moment_bytes=zero.per_rank_bytes(trainer.opt_state),
               param_bytes=sum(p.numel() * p.element_size()
                               for p in params.values()),
               whole_param_bytes=sum(
                   int(np.prod(par_sharding.full_shape(p))) * 4
                   for p in params.values()),
               cut_param_bytes=sum(params[n].numel() * 4 for n in cut),
               cut_whole_param_bytes=sum(
                   int(np.prod(par_sharding.full_shape(params[n]))) * 4
                   for n in cut),
               rows_per_rank=PAR_LAYOUT_BATCH // trainer.axis_size("data"))
    t2 = time.perf_counter()
    out["timing"] = par_timed(trainer, x, y)
    out["seconds"] = dict(gate=t1 - t0, fit=t2 - t1,
                          timed=time.perf_counter() - t2)
    par_worker_report(ctx, leg, **out)
    del model, trainer, params
    collect()


def par_worker_layout(seed):
    """Legs D-G on the launch's ranks, one after another over one process
    group (each leg's context makes its own mesh of groups)."""
    world = int(os.environ["ZOO_TPU_NUM_PROCESSES"])
    for leg in PAR_LAYOUT_LEGS:
        par_layout_leg(leg, seed, world)


def parallel_worker(leg, seed):
    """One rank of a leg of the parallel phase (the launcher's script)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.library()
    if leg in ("a", "a_resume"):
        par_worker_a(seed, resume=leg == "a_resume")
    elif leg == "layout":
        par_worker_layout(seed)
    else:
        par_worker_bc(seed)


def layout_reports():
    """Legs D-G's reports, {leg: each rank's}; the ranks' losses must
    agree."""
    layout = {leg: par_reports(leg, PAR_RANKS) for leg in PAR_LAYOUT_LEGS}
    for leg, ranks in layout.items():
        if any(r["losses"] != ranks[0]["losses"] for r in ranks):
            raise AssertionError(f"leg {leg.upper()}: the ranks' losses "
                                 f"differ {[r['losses'] for r in ranks]}")
    return layout


def layout_report(ref, layout):
    """Legs D-G's part of the parallel phase's report."""
    keys = ("rank", "gate", "losses", "launches", "zero_mode",
            "moment_bytes", "param_bytes", "whole_param_bytes",
            "cut_param_bytes", "cut_whole_param_bytes", "rows_per_rank",
            "fit_peak_memory_bytes", "peak_memory_bytes",
            "fit_collective_calls", "timing", "seconds")
    return {leg: dict(
        backend=ranks[0]["backend"], world=PAR_RANKS,
        config=ranks[0]["config"],
        gloo_host_routed_kinds=ranks[0]["gloo_host_routed_kinds"],
        in_process_moment_bytes=ref["moe" if leg == "f" else "dense"][
            "moment_bytes"],
        ranks=[{k: r[k] for k in keys if k in r} for r in ranks])
        for leg, ranks in layout.items()}


def layout_phase(seed, smi):
    """Legs D-G alone (``--phase layout``): the report and the K1-K5
    launches of every rank's fit."""
    t0 = time.perf_counter()
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    os.makedirs(PAR_ROOT)
    try:
        ref = par_layout_reference(seed)
        seconds = par_launch("layout", PAR_RANKS, seed)
        layout = layout_reports()
    finally:
        shutil.rmtree(PAR_ROOT, ignore_errors=True)
    launches = par_sum_launches(*(r["launches"] for ranks in
                                  layout.values() for r in ranks))
    return dict(card=smi, legs_d_to_g=layout_report(ref, layout),
                launch_s=dict(d_to_g=seconds), launches=launches,
                wall_s=time.perf_counter() - t0), launches


def par_sum_launches(*reports):
    out = {}
    for launches in reports:
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def parallel_phase(seed, dev, smi):
    """The parallel phase (see the module docstring): returns the report
    and the K1-K5 launches of every rank of the three legs' fits."""
    t0 = time.perf_counter()
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    os.makedirs(PAR_ROOT)
    try:
        ref = par_reference(seed, dev)
        layout_ref = par_layout_reference(seed)
        ref_s = time.perf_counter() - t0
        # leg A: one rank over NCCL through the launcher, then resumed
        sharded = {"ZOO_TPU_SHARDED_CHECKPOINT": "1"}
        a_s = par_launch("a", 1, seed, sharded)
        a2_s = par_launch("a_resume", 1, seed, sharded)
        (a,), (a2,) = par_reports("a", 1), par_reports("a_resume", 1)
        if a["losses"] != ref["losses"]:
            raise AssertionError(f"leg A: losses {a['losses']} vs the "
                                 f"in-process fit's {ref['losses']}")
        if a2["losses"] != a["losses"][PAR_SAVE_AT:]:
            raise AssertionError(f"leg A: resumed losses {a2['losses']} vs "
                                 f"{a['losses'][PAR_SAVE_AT:]}")
        if "sharded.commit" not in a["checkpoint"]:
            raise AssertionError(f"leg A checkpoint {a['checkpoint']}")
        # legs B (data_parallel=2, ZeRO-1), C (sequence_parallel=2,
        # Ulysses then ring) and D-G (tensor, pipeline, expert
        # parallelism, FSDP): two ranks sharing the card, one launch
        bc_s = par_launch("bc", PAR_RANKS, seed)
        b, c = par_reports("b", PAR_RANKS), par_reports("c", PAR_RANKS)
        if b[0]["losses"] != b[1]["losses"]:
            raise AssertionError(f"leg B: the ranks' losses differ "
                                 f"{b[0]['losses']} {b[1]['losses']}")
        layout = layout_reports()
    finally:
        shutil.rmtree(PAR_ROOT, ignore_errors=True)
    launches = par_sum_launches(
        a["launches"], a2["launches"], *(r["launches"] for r in b),
        *(m["launches"] for r in c for m in r["modes"].values()),
        *(r["launches"] for ranks in layout.values() for r in ranks))

    def rank_view(r, *keys):
        return {k: r[k] for k in keys if k in r}

    report = dict(
        card=smi, model="BERT-base classifier (bench.py:353-438)",
        config=PAR_CONFIG, seed=seed, batch=TRAIN_BATCH,
        reference=dict(losses=ref["losses"], moment_bytes=ref[
            "moment_bytes"], f32_loss=ref["f32_loss"], wall_s=ref_s),
        leg_a=dict(backend=a["backend"], world=a["world"],
                   losses=a["losses"], resumed_losses=a2["losses"],
                   seconds=a["seconds"], resumed_seconds=a2["seconds"],
                   bit_equal_to_in_process=True, bit_equal_resumed=True,
                   launches=a["launches"], checkpoint=a["checkpoint"],
                   peak_memory_bytes=a["peak_memory_bytes"],
                   moment_bytes=a["moment_bytes"], timing=a["timing"]),
        leg_b=dict(backend=b[0]["backend"], world=PAR_RANKS,
                   gloo_host_routed_kinds=b[0]["gloo_host_routed_kinds"],
                   ranks=[rank_view(r, "gate", "losses", "launches",
                                    "batch_per_rank", "zero_mode",
                                    "moment_bytes", "peak_memory_bytes",
                                    "fit_collective_calls", "timing",
                                    "seconds")
                          for r in b],
                   moment_bytes_vs_leg_a=[r["moment_bytes"] /
                                          a["moment_bytes"] for r in b]),
        leg_c=dict(backend=c[0]["backend"], world=PAR_RANKS,
                   gloo_host_routed_kinds=c[0]["gloo_host_routed_kinds"],
                   ranks=[rank_view(r, "rank", "modes", "seconds")
                          for r in c]),
        legs_d_to_g=layout_report(layout_ref, layout),
        launch_s=dict(a=a_s, a_resume=a2_s, b_to_g=bc_s),
        launches=launches, wall_s=time.perf_counter() - t0)
    return report, launches


# ---------------------------------------------------------------------------
# 20. interop: ResNet-50 from ONNX and from Caffe, BERT-base with a PyTorch
# head
# ---------------------------------------------------------------------------

IO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_interop")
# leg A-B: batches of 16 x 3 x 224 x 224, served after one warm batch
IO_BATCH, IO_TIMED_BATCHES = 16, 8
IO_CPU_ROWS = 2
# an imported ResNet-50's softmax rows against the native
# ImageClassifier.predict on the card (TF32 off), and against its own CPU
# run: the same float32 convolutions, but batch norm computed as ONNX and
# Caffe write it, (x - mean) / sqrt(var + eps) * gamma + beta, where the
# native layer folds it otherwise, and Caffe's pool5 a 7 x 7 average where
# the native layer takes a mean: rounding alone, 1e-4 as RESNET_PREDICT_TOL
IO_ROW_TOL = 1e-4
# Caffe's BatchNorm takes eps 1e-5 (the published prototxt sets none); the
# native layer's 1e-3 goes into the variance blob instead
CAFFE_BN_EPS = 1e-5
# leg C: bench.py's classifier, its Dense(2) head a TorchNet of
# nn.Linear(768, 2) under a TorchCriterion, bf16 at 32 x 512, dropout 0.1
# in both models; each step's loss against the native head's from the
# same weights, relative: the Dense head rounds its softmax to bf16 where
# the torch loss takes the bf16 logits (BF16_LOSS_TOL)
IO_STEPS = 4
IO_LOSS_TOL = BF16_LOSS_TOL
# the two heads' steps timed in alternating windows of TIMED_STEPS
IO_TIMED_WINDOWS = 2
# leg E: the frozen graph tools/make_tf_fixtures.py wrote with TensorFlow,
# TF's rows of its inputs, and its manifest (SHA-256 of each file). Its
# rows on the card against TensorFlow's (CPU, oneDNN) within IO_ROW_TOL;
# one SGD step of the graph under a Dense(3) head on the card against the
# CPU's from the same weights: the loss within TF_STEP_LOSS_TOL, each
# parameter's gradient within TF_STEP_GRAD_TOL of its norm
TF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "tf_fixtures")
TF_STEP_LOSS_TOL, TF_STEP_GRAD_TOL = 1e-5, 1e-4


def _np32(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _linear(layer):
    act = getattr(layer, "activation", None)
    return act is None or getattr(act, "name", "linear") in ("linear",
                                                             None)


def resnet_onnx_bytes(model):
    """``model`` (ImageClassifier("resnet-50")'s NCHW graph, weights and
    moving statistics as they are) as ONNX opset 13, written with the
    port's builder: Conv (ZeroPadding2D and XLA's SAME folded into its
    pads), BatchNormalization, Relu, MaxPool, Add, GlobalAveragePool,
    Flatten, Gemm and the head's Softmax. Kernels are initializers named
    ``<layer>_w`` (a QuantizedModel kernel key)."""
    graph = model.graph_function()
    (inp,) = graph.inputs
    out_of, pads_of = {inp.id: "data"}, {}
    nodes, inits = [], {}
    N = onnx_builder.make_node

    def src(v):
        return out_of[v.id if v.node is None else v.node.id]

    for node in graph.nodes:
        layer, ins, name = node.layer, node.inputs, node.layer.name
        if isinstance(layer, L.ZeroPadding2D):
            out_of[node.id] = src(ins[0])
            pads_of[node.id] = layer.padding
            continue
        if isinstance(layer, L.Convolution2D):
            if not _linear(layer) or layer.dim_ordering != "th":
                raise ValueError(f"{name}: not a linear NCHW convolution")
            v = ins[0]
            (pt, pb), (pl, pr) = pads_of.get(
                None if v.node is None else v.node.id, ((0, 0), (0, 0)))
            k = tuple(layer.kernel_size)
            same = same_pads(v.shape[2:], k, layer.subsample) \
                if layer.border_mode == "same" else [(0, 0), (0, 0)]
            inits[f"{name}_w"] = _np32(layer.kernel.permute(3, 2, 0, 1))
            args = [src(v), f"{name}_w"]
            if layer.use_bias:
                inits[f"{name}_b"] = _np32(layer.bias)
                args.append(f"{name}_b")
            nodes.append(N("Conv", args, [name], kernel_shape=list(k),
                           strides=list(layer.subsample),
                           pads=[pt + same[0][0], pl + same[1][0],
                                 pb + same[0][1], pr + same[1][1]]))
        elif isinstance(layer, L.BatchNormalization):
            for part in ("gamma", "beta"):
                inits[f"{name}_{part}"] = _np32(getattr(layer, part))
            inits[f"{name}_mean"] = _np32(layer.moving_mean)
            inits[f"{name}_var"] = _np32(layer.moving_var)
            nodes.append(N("BatchNormalization",
                           [src(ins[0])] + [f"{name}_{p}" for p in (
                               "gamma", "beta", "mean", "var")], [name],
                           epsilon=float(layer.epsilon)))
        elif isinstance(layer, L.Activation):
            if getattr(layer.fn, "name", None) != "relu":
                raise ValueError(f"{name}: activation {layer.fn}")
            nodes.append(N("Relu", [src(ins[0])], [name]))
        elif isinstance(layer, L.MaxPooling2D):
            v = ins[0]
            same = same_pads(v.shape[2:], layer.pool_size, layer.strides) \
                if layer.border_mode == "same" else [(0, 0), (0, 0)]
            nodes.append(N("MaxPool", [src(v)], [name],
                           kernel_shape=list(layer.pool_size),
                           strides=list(layer.strides),
                           pads=[same[0][0], same[1][0], same[0][1],
                                 same[1][1]]))
        elif isinstance(layer, L.Add):
            nodes.append(N("Add", [src(v) for v in ins], [name]))
        elif isinstance(layer, L.GlobalAveragePooling2D):
            nodes.append(N("GlobalAveragePool", [src(ins[0])],
                           [name + "_gap"]))
            nodes.append(N("Flatten", [name + "_gap"], [name]))
        elif isinstance(layer, L.Dense):
            inits[f"{name}_w"] = _np32(layer.kernel)
            inits[f"{name}_b"] = _np32(layer.bias)
            nodes.append(N("Gemm", [src(ins[0]), f"{name}_w", f"{name}_b"],
                           [name + "_logits"]))
            if getattr(layer.activation, "name", None) != "softmax":
                raise ValueError(f"{name}: activation {layer.activation}")
            nodes.append(N("Softmax", [name + "_logits"], [name], axis=1))
        else:
            raise ValueError(f"{name}: {type(layer).__name__} has no ONNX "
                             "export here")
        out_of[node.id] = name
    (out,) = graph.outputs
    g = onnx_builder.make_graph(
        nodes, "resnet50",
        [onnx_builder.value_info("data", (None,) + tuple(inp.shape[1:]))],
        [onnx_builder.value_info(src(out), (None,) + tuple(out.shape[1:]))],
        inits)
    return onnx_builder.make_model(g, opset=13)


def _resnet_blocks(model):
    """The native ResNet-50's layers in the published deploy layout's
    order: (stem conv, stem BN), then per bottleneck (branch1 conv and BN
    or None, [(conv, BN) of branch2a-2c]), and the head Dense. Walked back
    from each Add: input 0 is branch2c's BN, input 1 the shortcut."""
    nodes = model.graph_function().nodes
    stem = next(n for n in nodes if isinstance(n.layer, L.Convolution2D))
    stem_bn = next(n for n in nodes if isinstance(n.layer,
                                                  L.BatchNormalization))
    blocks = []
    for n in nodes:
        if not isinstance(n.layer, L.Add):
            continue
        branch, v = [], n.inputs[0]
        while len(branch) < 3:
            bn = v.node
            conv = bn.inputs[0].node
            branch.append((conv.layer, bn.layer))
            v = conv.inputs[0]
            if len(branch) < 3:
                v = v.node.inputs[0]            # through the ReLU
        short = n.inputs[1].node
        shortcut = None
        if isinstance(short.layer, L.BatchNormalization):
            shortcut = (short.inputs[0].node.layer, short.layer)
        blocks.append((shortcut, branch[::-1]))
    head = next(n.layer for n in nodes if isinstance(n.layer, L.Dense))
    return (stem.layer, stem_bn.layer), blocks, head


def resnet_caffe_files(model, root):
    """``model`` (the native ResNet-50) written as KaimingHe/
    deep-residual-networks' ``ResNet-50-deploy.prototxt`` lays it out
    (conv1 with a bias, BatchNorm with use_global_stats + Scale after
    every convolution, branch1 shortcuts, the stride in branch2a, Eltwise
    sums, in-place ReLUs, ceil-mode pool1 3 x 3 / 2, pool5 AVE 7 x 7,
    fc1000, prob) and a caffemodel of its weights, each blob packed from
    numpy bytes (the native BatchNorm's epsilon folded into the variance
    blob, CAFFE_BN_EPS). Returns (prototxt path, caffemodel path)."""
    (stem, stem_bn), blocks, head = _resnet_blocks(model)
    text = ['name: "ResNet-50"', 'input: "data"'] + \
        [f"input_dim: {d}" for d in (1, 3, 224, 224)]
    layers = []

    def blob(arr):
        arr = np.ascontiguousarray(arr, np.float32)
        return {"shape": {"dim": list(arr.shape)}, "data": arr.ravel()}

    def conv(name, bottom, layer, stride, pad, bias):
        k = layer.kernel_size[0]
        param = f"num_output: {layer.nb_filter} kernel_size: {k} " \
                f"pad: {pad} stride: {stride}"
        if not bias:
            param += " bias_term: false"
        text.append(f'layer {{ bottom: "{bottom}" top: "{name}" name: '
                    f'"{name}" type: "Convolution" convolution_param {{ '
                    f'{param} }} }}')
        blobs = [blob(_np32(layer.kernel.permute(3, 2, 0, 1)))]
        if bias:
            blobs.append(blob(np.zeros(layer.nb_filter, np.float32)))
        layers.append({"name": name, "type": "Convolution",
                       "blobs": blobs})

    def bn_scale(suffix, top, layer):
        text.append(f'layer {{ bottom: "{top}" top: "{top}" name: '
                    f'"bn{suffix}" type: "BatchNorm" batch_norm_param {{ '
                    f'use_global_stats: true }} }}')
        text.append(f'layer {{ bottom: "{top}" top: "{top}" name: '
                    f'"scale{suffix}" type: "Scale" scale_param {{ '
                    f'bias_term: true }} }}')
        var = _np32(layer.moving_var) + (layer.epsilon - CAFFE_BN_EPS)
        layers.append({"name": f"bn{suffix}", "type": "BatchNorm", "blobs": [
            blob(_np32(layer.moving_mean)), blob(var),
            blob(np.ones(1, np.float32))]})
        layers.append({"name": f"scale{suffix}", "type": "Scale", "blobs": [
            blob(_np32(layer.gamma)), blob(_np32(layer.beta))]})

    def relu(top):
        text.append(f'layer {{ bottom: "{top}" top: "{top}" name: '
                    f'"{top}_relu" type: "ReLU" }}')

    conv("conv1", "data", stem, 2, 3, True)
    bn_scale("_conv1", "conv1", stem_bn)
    relu("conv1")
    text.append('layer { bottom: "conv1" top: "pool1" name: "pool1" type: '
                '"Pooling" pooling_param { kernel_size: 3 stride: 2 '
                'pool: MAX } }')
    bottom, i = "pool1", 0
    for stage, n_blocks in zip((2, 3, 4, 5), (3, 4, 6, 3)):
        for b in range(n_blocks):
            shortcut, branch = blocks[i]
            i += 1
            res = f"res{stage}{'abcdef'[b]}"
            stride = 2 if b == 0 and stage > 2 else 1
            short_top = bottom
            if shortcut is not None:
                conv(f"{res}_branch1", bottom, shortcut[0], stride, 0,
                     False)
                bn_scale(f"{res[3:]}_branch1", f"{res}_branch1",
                         shortcut[1])
                short_top = f"{res}_branch1"
            top = bottom
            for part, (c, bn) in zip("abc", branch):
                name = f"{res}_branch2{part}"
                conv(name, top, c, stride if part == "a" else 1,
                     1 if part == "b" else 0, False)
                bn_scale(f"{res[3:]}_branch2{part}", name, bn)
                if part != "c":
                    relu(name)
                top = name
            text.append(f'layer {{ bottom: "{short_top}" bottom: "{top}" '
                        f'top: "{res}" name: "{res}" type: "Eltwise" }}')
            relu(res)
            bottom = res
    text.append(f'layer {{ bottom: "{bottom}" top: "pool5" name: "pool5" '
                'type: "Pooling" pooling_param { kernel_size: 7 stride: 1 '
                'pool: AVE } }')
    text.append('layer { bottom: "pool5" top: "fc1000" name: "fc1000" '
                f'type: "InnerProduct" inner_product_param {{ num_output: '
                f'{head.output_dim} }} }}')
    text.append('layer { bottom: "fc1000" top: "prob" name: "prob" type: '
                '"Softmax" }')
    layers.append({"name": "fc1000", "type": "InnerProduct", "blobs": [
        blob(_np32(head.kernel).T), blob(_np32(head.bias))]})
    os.makedirs(root, exist_ok=True)
    ptx = os.path.join(root, "ResNet-50-deploy.prototxt")
    cm = os.path.join(root, "ResNet-50-model.caffemodel")
    with open(ptx, "w") as f:
        f.write("\n".join(text) + "\n")
    with open(cm, "wb") as f:
        f.write(caffe_proto.encode({"name": "ResNet-50", "layer": layers},
                                   "NetParameter"))
    return ptx, cm


def io_rows(im, x):
    """``im``'s rows of ``x`` in batches of IO_BATCH, as one array."""
    return np.concatenate([np.asarray(im.predict(x[i:i + IO_BATCH]))
                           for i in range(0, len(x), IO_BATCH)])


def io_records_per_s(im, x):
    """Records/s of IO_TIMED_BATCHES predicts of IO_BATCH rows (host
    copies of the rows included), after one warm batch."""
    im.predict(x[:IO_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(IO_TIMED_BATCHES):
        j = (i * IO_BATCH) % len(x)
        im.predict(x[j:j + IO_BATCH])
    return IO_TIMED_BATCHES * IO_BATCH / (time.perf_counter() - t0)


def io_int8_weights(im):
    """{kernel leaf name: its int8 values} of a quantized model (the
    imported layer's own name differs from load to load)."""
    return {path.rsplit("['", 1)[-1]: qt.q.cpu()
            for path, qt in im.model.kernels.items()}


def io_leg(what, load, native_rows, x, cpu_x, want_kernels):
    """One importer leg: load float32 (timed) and int8 on the card and on
    the CPU; rows against the native model's and the CPU's; the int8
    weights against the CPU's; records/s."""
    t0 = time.perf_counter()
    im = load(quantize=False, device=None)
    first_load_s = time.perf_counter() - t0
    del im
    t0 = time.perf_counter()
    im = load(quantize=False, device=None)
    load_s = time.perf_counter() - t0
    rows = io_rows(im, x)
    err = float(np.abs(rows - native_rows).max())
    cpu_rows = load(quantize=False, device="cpu").predict(cpu_x)
    cpu_err = float(np.abs(rows[:len(cpu_x)] - cpu_rows).max())
    if not np.isfinite(rows).all() or err > IO_ROW_TOL or \
            cpu_err > IO_ROW_TOL:
        raise AssertionError(f"{what}: rows {err} from the native model's, "
                             f"{cpu_err} from the CPU's (limit "
                             f"{IO_ROW_TOL})")
    q = load(quantize=True, device=None)
    q_cpu = load(quantize=True, device="cpu")
    card_q, cpu_q = io_int8_weights(q), io_int8_weights(q_cpu)
    if len(card_q) != want_kernels or sorted(card_q) != sorted(cpu_q) or \
            any(not torch.equal(card_q[k], cpu_q[k]) for k in card_q):
        raise AssertionError(f"{what}: {len(card_q)} int8 kernels (want "
                             f"{want_kernels}), equal to the CPU's: "
                             f"{sorted(card_q) == sorted(cpu_q)}")
    q_rows = q.predict(x[:IO_BATCH])
    q_err = float(np.abs(q_rows[:len(cpu_x)] - q_cpu.predict(cpu_x)).max())
    if q_err > IO_ROW_TOL:
        raise AssertionError(f"{what}: int8 rows {q_err} from the CPU's")
    rate = io_records_per_s(im, x)
    report = dict(first_load_s=first_load_s, load_s=load_s,
                  max_abs_err_vs_native=err,
                  max_abs_err_vs_cpu=cpu_err, row_tol=IO_ROW_TOL,
                  int8_kernels=len(card_q), int8_weights_equal_cpu=True,
                  int8_max_abs_err_vs_cpu=q_err,
                  int8_max_abs_diff_vs_float=float(
                      np.abs(q_rows - rows[:IO_BATCH]).max()),
                  records_per_s=rate)
    del im, q, q_cpu
    collect()
    return report


def io_resnet_legs(seed, dev):
    """Legs A-B: the native ResNet-50 (weights from ``seed``), exported to
    ONNX and to the Caffe deploy layout, loaded back through
    ``InferenceModel.load_onnx`` / ``load_caffe`` and served."""
    clf = build_resnet(seed)
    rs = np.random.default_rng(seed + 1)
    x = rs.standard_normal((2 * IO_BATCH,) + RESNET_SHAPE).astype(
        np.float32)
    cpu_x = x[:IO_CPU_ROWS]
    native = InferenceModel().load_keras_net(clf)
    native_rows = io_rows(native, x)
    native_rate = io_records_per_s(native, x)
    os.makedirs(IO_ROOT, exist_ok=True)
    cpu_model = clf.model.to("cpu")
    t0 = time.perf_counter()
    path = os.path.join(IO_ROOT, "resnet50.onnx")
    with open(path, "wb") as f:
        f.write(resnet_onnx_bytes(cpu_model))
    onnx_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptx, cm = resnet_caffe_files(cpu_model, IO_ROOT)
    caffe_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tf_path = cpu_model.export_tf(os.path.join(IO_ROOT, "resnet50_tf"))
    tf_write_s = time.perf_counter() - t0
    n_kernels = sum(1 for l in cpu_model.graph_function().layers
                    if isinstance(l, (L.Convolution2D, L.Dense)))
    del native, clf, cpu_model
    collect()
    a = io_leg("leg A (ONNX)", lambda quantize, device: InferenceModel()
               .load_onnx(path, quantize=quantize, device=device),
               native_rows, x, cpu_x, n_kernels)
    b = io_leg("leg B (Caffe)", lambda quantize, device: InferenceModel()
               .load_caffe(ptx, cm, quantize=quantize, device=device),
               native_rows, x, cpu_x, 0)
    d = io_tf_leg(tf_path, native_rows, x, cpu_x)
    d.update(write_s=tf_write_s, native_records_per_s=native_rate,
             file_mb=os.path.getsize(os.path.join(
                 tf_path, "saved_model.pb")) / 2 ** 20)
    a.update(file_mb=os.path.getsize(path) / 2 ** 20, write_s=onnx_write_s,
             opset=13, ops=sorted({"Conv", "BatchNormalization", "Relu",
                                   "MaxPool", "Add", "GlobalAveragePool",
                                   "Flatten", "Gemm", "Softmax"}))
    b.update(file_mb=os.path.getsize(cm) / 2 ** 20, write_s=caffe_write_s,
             layout="KaimingHe/deep-residual-networks ResNet-50-deploy"
                    ".prototxt", bn_eps=CAFFE_BN_EPS,
             int8_note="blobs are named '<layer>/<blob>', no kernel key: "
                       "quantize=True keeps every blob float32, as the JAX "
                       "package's QuantizedModel does")
    return dict(native_records_per_s=native_rate, onnx=a, caffe=b,
                tf_export=d, batch=IO_BATCH, timed_batches=IO_TIMED_BATCHES)


def io_tf_leg(path, native_rows, x, cpu_x):
    """Leg D: the exported SavedModel loaded by ``InferenceModel.load_tf``
    on the card (timed, twice) and on the CPU; rows against the native
    model's and the CPU's; records/s."""
    t0 = time.perf_counter()
    im = InferenceModel().load_tf(path)
    first_load_s = time.perf_counter() - t0
    del im
    t0 = time.perf_counter()
    im = InferenceModel().load_tf(path)
    load_s = time.perf_counter() - t0
    net = im.model
    if not isinstance(net, TFNet) or net.mode != "torch" or \
            net.device.type != "cuda":
        raise AssertionError(f"leg D loaded {type(net).__name__} in mode "
                             f"{getattr(net, 'mode', None)} on "
                             f"{getattr(net, 'device', None)}")
    rows = io_rows(im, x)
    err = float(np.abs(rows - native_rows).max())
    cpu_rows = InferenceModel().load_tf(path, device="cpu").predict(cpu_x)
    cpu_err = float(np.abs(rows[:len(cpu_x)] - cpu_rows).max())
    if not np.isfinite(rows).all() or err > IO_ROW_TOL or \
            cpu_err > IO_ROW_TOL:
        raise AssertionError(f"leg D (TF SavedModel): rows {err} from the "
                             f"native model's, {cpu_err} from the CPU's "
                             f"(limit {IO_ROW_TOL})")
    rate = io_records_per_s(im, x)
    report = dict(first_load_s=first_load_s, load_s=load_s,
                  max_abs_err_vs_native=err, max_abs_err_vs_cpu=cpu_err,
                  row_tol=IO_ROW_TOL, records_per_s=rate,
                  ops=net.graph_fn.ops, params=len(net.param_tree()),
                  route="KerasNet.export_tf -> InferenceModel.load_tf")
    del im, net
    collect()
    return report


def tf_fixture():
    """The committed frozen graph, its inputs and TensorFlow's rows, each
    file checked against the manifest's SHA-256."""
    with open(os.path.join(TF_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in manifest["sha256"].items():
        with open(os.path.join(TF_FIXTURES, name), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise AssertionError(f"tools/tf_fixtures/{name}: SHA-256 {got}, "
                                 f"manifest {want}")
    return (os.path.join(TF_FIXTURES, manifest["graph"]),
            np.load(os.path.join(TF_FIXTURES, "inputs.npy")),
            np.load(os.path.join(TF_FIXTURES, "rows.npy")), manifest)


def tf_head_model(pb, seed):
    """The fixture graph as a TFNet layer under a Dense(3) head, weights
    from ``seed`` (the graph's Consts as they are)."""
    net = Net.load_tf(pb)
    net.name = "graph"          # one parameter name on the card and CPU
    inp = L.Input(shape=(32, 32, 3))
    return Model(inp, L.Dense(3, name="head")(net(inp)), seed=seed), net


def io_tf_graph_leg(seed, dev):
    """Leg E: TensorFlow's frozen graph through ``Net.load_tf`` on the
    card against TensorFlow's rows; one SGD step of it under a Dense head
    on the card against the CPU's."""
    pb, x, tf_rows, manifest = tf_fixture()
    t0 = time.perf_counter()
    net = Net.load_tf(pb).to(dev)
    load_s = time.perf_counter() - t0
    if net.mode != "torch" or set(net.graph_fn.ops) != set(manifest["ops"]):
        raise AssertionError(f"leg E: mode {net.mode}, ops "
                             f"{net.graph_fn.ops}")
    rows = net.predict(x)
    err = float(np.abs(rows - tf_rows).max())
    if not np.isfinite(rows).all() or err > IO_ROW_TOL:
        raise AssertionError(f"leg E: rows {err} from TensorFlow's (limit "
                             f"{IO_ROW_TOL})")
    y = np.random.default_rng(seed).integers(0, 3, len(x)).astype(np.int32)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    steps = {}
    for where in ("card", "cpu"):
        model, tfnet = tf_head_model(pb, seed)
        trainer = SPMDTrainer(model, loss_fn, get_optimizer("sgd"),
                              device=dev if where == "card" else "cpu")
        trainer.ensure_initialized()
        loss = trainer.train_step(trainer.put_batch(
            ([x], y, np.ones(len(y), np.float32)))).item()
        steps[where] = (loss, {n: p.grad.detach().cpu() for n, p in
                               model.named_parameters()}, tfnet)
    (card_loss, card_g, card_net), (cpu_loss, cpu_g, _) = \
        steps["card"], steps["cpu"]
    grad_err = {n: float((card_g[n] - g).abs().max() /
                         max(g.norm().item(), 1e-12))
                for n, g in cpu_g.items()}
    worst = max(grad_err.values())
    if card_net.device.type != "cuda" or \
            abs(card_loss - cpu_loss) > TF_STEP_LOSS_TOL or \
            worst > TF_STEP_GRAD_TOL or \
            not all(g.abs().max() > 0 for g in card_g.values()):
        raise AssertionError(f"leg E step: loss {card_loss} vs the CPU's "
                             f"{cpu_loss}, worst gradient {worst} of its "
                             f"norm (limits {TF_STEP_LOSS_TOL}, "
                             f"{TF_STEP_GRAD_TOL})")
    return dict(graph="tools/tf_fixtures/classifier.pb",
                written_by=f"tensorflow {manifest['tensorflow']}",
                ops=manifest["ops"], load_s=load_s, rows=len(rows),
                max_abs_err_vs_tensorflow=err, row_tol=IO_ROW_TOL,
                step_loss_card=card_loss, step_loss_cpu=cpu_loss,
                step_loss_tol=TF_STEP_LOSS_TOL,
                step_params=len(grad_err),
                step_max_grad_err_rel_norm=worst,
                step_grad_tol=TF_STEP_GRAD_TOL)


def io_head_models(seed):
    """bench.py's classifier twice from one draw, dropout 0.1 (K4/K5 run
    only with dropout on; both models draw the same masks from the step's
    generator, the heads draw none): the native Dense(2, softmax) head,
    and a TorchNet of nn.Linear(768, 2) holding the Dense's kernel
    (transposed) and bias and the same BERT weights."""
    config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    native = build_classifier(seed, config)
    l = config["seq_len"]
    ins = [L.Input(shape=(l,), name="tokens"),
           L.Input(shape=(l,), name="positions"),
           L.Input(shape=(l,), name="segments"),
           L.Input(shape=(1, 1, l), name="mask")]
    _, pooled = L.BERT(**config)(ins)
    head = torch.nn.Linear(config["hidden_size"], N_CLASSES)
    net = TorchNet.from_pytorch(head)
    model = Model(ins, net(pooled), seed=seed)
    native_layers = native.graph_function().layers
    model.graph_function()
    bert_n = next(l for l in native_layers if isinstance(l, L.BERT))
    bert_t = next(l for l in model.graph_function().layers
                  if isinstance(l, L.BERT))
    dense = next(l for l in native_layers if isinstance(l, L.Dense))
    with torch.no_grad():
        for (na, a), (nb, b) in zip(bert_n.named_parameters(),
                                    bert_t.named_parameters()):
            if na != nb:
                raise AssertionError(f"BERT parameters {na} vs {nb}")
            b.copy_(a)
        head.weight.copy_(dense.kernel.t())
        head.bias.copy_(dense.bias)
    return native, model, head


def _torch_head_loss(logits, labels):
    return F.cross_entropy(logits.float(), labels.long().reshape(-1))


def io_torch_leg(seed, dev):
    """Leg C: both classifiers ``fit`` in bf16 for IO_STEPS steps on one
    seeded batch of 32 x 512 int32 ids, dropout 0.1; K1-K5's launches a
    step, each
    loss against the native head's, gradients on the torch module, then
    the step time of each."""
    native, model, head = io_head_models(seed)
    native.compile(optimizer=Adam(lr=TRAIN_LR),
                   loss="sparse_categorical_crossentropy")
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss=TorchCriterion.from_pytorch(_torch_head_loss))
    for m in (native, model):
        m.set_compute_dtype("bfloat16")
    x, y, _ = train_data(seed, TRAIN_BATCH, ids=np.int32)
    w0 = head.weight.detach().clone()
    native.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=IO_STEPS)
    native_losses = list(native.trainer.step_losses)
    torch.cuda.synchronize()
    _kernels.LAUNCHES.reset()
    model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=IO_STEPS)
    torch.cuda.synchronize()
    launches = _kernels.LAUNCHES.snapshot()
    losses = list(model.trainer.step_losses)
    n_block = BERT_CONFIG["n_block"]
    per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                attn.DKV_KERNEL_NAME: n_block,
                dln.FWD_KERNEL_NAME: 2 * n_block,
                dln.BWD_KERNEL_NAME: 2 * n_block}
    if launches != {k: IO_STEPS * v for k, v in per_step.items()}:
        raise AssertionError(f"leg C launches {launches}, per step "
                             f"{per_step}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, native_losses)]
    if len(losses) != IO_STEPS or not np.isfinite(losses).all() or \
            max(rel) > IO_LOSS_TOL:
        raise AssertionError(f"leg C losses {losses} against the native "
                             f"head's {native_losses} (limit "
                             f"{IO_LOSS_TOL} relative)")
    grad = head.weight.grad
    moved = float((head.weight.detach() - w0.to(head.weight.device))
                  .abs().max())
    if grad is None or not torch.isfinite(grad).all() or \
            float(grad.abs().max()) == 0.0 or moved == 0.0 or \
            head.weight.device != dev:
        raise AssertionError(f"leg C: the torch module's gradient "
                             f"{None if grad is None else grad.abs().max()}"
                             f", moved {moved}, on {head.weight.device}")
    timing = {"torchnet_head": [], "dense_head": []}
    for w in range(IO_TIMED_WINDOWS):       # alternating windows
        order = (("torchnet_head", model), ("dense_head", native))
        for name, m in order if w % 2 == 0 else order[::-1]:
            timing[name] += io_step_ms(m, x, y)
    return dict(model="BERT-base classifier (bench.py:353-438), head "
                      "TorchNet(nn.Linear(768, 2)) + TorchCriterion",
                compute_dtype="bfloat16", batch=TRAIN_BATCH, steps=IO_STEPS,
                losses=losses, native_head_losses=native_losses,
                max_rel_loss_diff=max(rel), loss_tol=IO_LOSS_TOL,
                launches=launches, launches_per_step=per_step,
                torch_module_grad_max=float(grad.abs().max()),
                torch_module_moved=moved,
                step_p50_ms={k: 1e3 * percentile(v, 50) for k, v in
                             timing.items()},
                step_ms={k: [1e3 * t for t in v] for k, v in
                         timing.items()},
                timed_windows=IO_TIMED_WINDOWS), launches


def io_step_ms(model, x, y):
    """TIMED_STEPS more bf16 training steps of ``model`` on (x, y), one
    at a time: their seconds."""
    trainer = model.trainer
    batch = trainer.put_batch((x, y, np.ones(len(y), np.float32)))
    step_s = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return step_s


def interop_phase(seed, dev, smi):
    """The interop phase: legs A-B and D (ResNet-50 through the ONNX and
    Caffe importers and through export_tf -> load_tf), leg E (a graph
    TensorFlow wrote), K1-K5 launched 0 times in each, and leg C
    (BERT-base with a PyTorch head, K1-K5 at 12/12/12/24/24 a step).
    Returns the report and K1-K5's launches over the phase."""
    t0 = time.perf_counter()
    shutil.rmtree(IO_ROOT, ignore_errors=True)
    _kernels.LAUNCHES.reset()
    resnets = io_resnet_legs(seed + 70, dev)
    ab_launches = _kernels.LAUNCHES.snapshot()
    if ab_launches:
        raise AssertionError(f"legs A, B and D launched {ab_launches}")
    collect()
    torch.cuda.synchronize()
    _kernels.LAUNCHES.reset()
    tf_graph = io_tf_graph_leg(seed + 72, dev)
    torch.cuda.synchronize()
    e_launches = _kernels.LAUNCHES.snapshot()
    if e_launches:
        raise AssertionError(f"leg E launched {e_launches}")
    collect()
    torch_report, launches = io_torch_leg(seed + 71, dev)
    shutil.rmtree(IO_ROOT, ignore_errors=True)
    return dict(card=smi, leg_a_onnx=resnets["onnx"],
                leg_b_caffe=resnets["caffe"],
                leg_d_tf_export=resnets["tf_export"],
                leg_e_tf_graph=tf_graph,
                native_records_per_s=resnets["native_records_per_s"],
                batch=IO_BATCH, leg_c_torchnet=torch_report,
                launches_legs_a_b_d=ab_launches,
                launches_leg_e=e_launches,
                clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu"),
                wall_s=time.perf_counter() - t0), launches


# the estimators phase: nnframes, LocalEstimator, the attention
# backward's other routes, RayContext and AutoML
EST_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_estimators")
# leg A: a frame of 128 rows of bench.py's classifier input, fit at batch
# 32 (4 steps); the NNFrames step against Model.fit's in the same process
# from the same weights and rows (float32, dropout off): one trainer step
# on both sides, only the data path differs
EST_ROWS = 128
EST_STEPS = EST_ROWS // TRAIN_BATCH
EST_LOSS_TOL = 1e-6
EST_ROW_TOL = 1e-6
EST_WINDOWS = 2
# leg B: EleutherAI's pythia-2.8b (hidden 2560, 32 heads of d = 80, 2048
# positions, vocab 50304, intermediate 10240), depth cut from 32 blocks
# to 2; batch 4 x 2048, 2 fit steps, float32; the block's dq/dk/dv against
# autograd through attention_reference within 1e-4 of their scale
PYTHIA_CONFIG = dict(n_block=2, hidden_size=2560, n_head=32, vocab=50304,
                     seq_len=2048, intermediate_size=10240)
BLK_BATCH, BLK_STEPS, BLK_TOL = 4, 2, 1e-4
# leg C: the classifier at 32 x 512 under flash_remat="full", float32,
# dropout 0.1, 2 fit steps; each parameter's gradient against the default
# policy's within 1e-4 of its norm (the reference's f32 products against
# the backward kernels' 3xTF32 ones)
REMAT_STEPS, REMAT_GRAD_TOL = 2, 1e-4
# leg D: RayContext with 2 spawned workers sharing the card; an 8-trial
# ASHA search (rungs 1, 3, 9 epochs) of LSTMForecasters on a seeded sine
EST_WORKERS, EST_TRIALS = 2, 8
EST_SERIES, EST_LOOKBACK = 400, 24
EST_WAIT_S = 300.0


class BertRow(Preprocessing):
    """An assembled frame row (tokens, positions, segments, mask) -> the
    classifier's four inputs: int32 ids and the float32 (1, 1, L) mask."""

    def apply(self, row):
        tok, pos, seg, mask = row
        return [np.asarray(tok, np.int32), np.asarray(pos, np.int32),
                np.asarray(seg, np.int32),
                np.asarray(mask, np.float32).reshape(1, 1, -1)]


def est_frame(x, y):
    """A dict of columns (tokens, positions, segments, mask, label) and the
    assembled ``features`` column of their rows, as a Spark ML pipeline's
    assembler would give NNClassifier."""
    frame = {"tokens": list(x[0]), "positions": list(x[1]),
             "segments": list(x[2]), "mask": list(x[3][:, 0, 0]),
             "label": [float(v) for v in y]}
    frame["features"] = list(zip(frame["tokens"], frame["positions"],
                                 frame["segments"], frame["mask"]))
    return frame


def est_slice(frame, n):
    return {k: v[:n] for k, v in frame.items()}


def est_classifier(model, root, app):
    """bench.py's optimizer on an NNClassifier over ``model`` whose train
    summary goes to ``root/app``."""
    return (NNClassifier(model, feature_preprocessing=BertRow())
            .setBatchSize(TRAIN_BATCH).setMaxEpoch(1)
            .setOptimMethod(Adam(lr=TRAIN_LR))
            .setTrainSummary(TrainSummary(root, app)))


def est_losses(root, app):
    return [v for _, _, _, v in read_scalars(
        os.path.join(root, app, "train"), "Loss")]


def est_fit_ms(fit, steps=EST_STEPS):
    """Milliseconds a step of one ``fit`` call of ``steps`` steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def est_leg_a(seed, root):
    """Leg A: NNClassifier over bench.py's classifier on a dict frame."""
    cfg = zoo_nncontext.get_nncontext().config
    saved = (cfg.compute_dtype, cfg.log_every_n_steps)
    x, y, _ = train_data(seed, EST_ROWS, ids=np.int32)
    frame = est_frame(x, y)
    try:
        cfg.log_every_n_steps = 1
        # the NNFrames step against Model.fit's: float32, dropout off
        cfg.compute_dtype = "float32"
        off = dict(BERT_CONFIG, hidden_p_drop=0.0, attn_p_drop=0.0)
        nn_model, fit_model = build_classifier(seed, off), \
            build_classifier(seed, off)
        est_classifier(nn_model, root, "parity").fit(
            est_slice(frame, TRAIN_BATCH))
        fit_model.compile(optimizer=Adam(lr=TRAIN_LR),
                          loss="sparse_categorical_crossentropy")
        fit_model.fit([t[:TRAIN_BATCH] for t in x], y[:TRAIN_BATCH],
                      batch_size=TRAIN_BATCH, nb_epoch=1)
        nn_loss = est_losses(root, "parity")[0]
        fit_loss = fit_model.trainer.step_losses[0]
        parity_rel = abs(nn_loss - fit_loss) / abs(fit_loss)
        if not parity_rel <= EST_LOSS_TOL:
            raise AssertionError(f"leg A: the NNFrames step's loss "
                                 f"{nn_loss} against Model.fit's {fit_loss}")
        del nn_model, fit_model
        collect()

        # the bf16 fit: 4 steps at batch 32, dropout 0.1
        cfg.compute_dtype = "bfloat16"
        config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                      attn_p_drop=TRAIN_P_DROP)
        model = build_classifier(seed + 1, config)
        clf = est_classifier(model, root, "bf16")
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        nn_model = clf.fit(frame)
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES.snapshot()
        launch_dtypes = _kernels.LAUNCHES.by_dtype()
        losses = est_losses(root, "bf16")
        n_block = BERT_CONFIG["n_block"]
        per_step = {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                    attn.DKV_KERNEL_NAME: n_block,
                    dln.FWD_KERNEL_NAME: 2 * n_block,
                    dln.BWD_KERNEL_NAME: 2 * n_block}
        if launches != {k: EST_STEPS * v for k, v in per_step.items()} or \
                any(set(v) != {"bfloat16"} for v in launch_dtypes.values()):
            raise AssertionError(f"leg A launches {launch_dtypes}, per step "
                                 f"{per_step}")
        if len(losses) != EST_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"leg A losses {losses}")

        # transform against predict; save and load
        probs = model.predict(x, batch_size=TRAIN_BATCH)
        classes = np.asarray(nn_model.transform(frame)["prediction"])
        rows = np.asarray(NNModel(model, feature_preprocessing=BertRow())
                          .setBatchSize(TRAIN_BATCH)
                          .transform(frame)["prediction"], np.float32)
        row_err = float(np.abs(rows - probs).max())
        if not np.array_equal(classes, np.argmax(probs, -1)) or \
                row_err > EST_ROW_TOL:
            raise AssertionError(f"leg A: transform against predict, rows "
                                 f"{row_err}")
        path = os.path.join(root, "nnmodel")
        t0 = time.perf_counter()
        nn_model.save(path)
        loaded = NNModel.load(path)
        save_load_s = time.perf_counter() - t0
        loaded_rows = loaded.model.predict(x, batch_size=TRAIN_BATCH)
        loaded_err = float(np.abs(loaded_rows - probs).max())
        if type(loaded) is not NNClassifierModel or not np.array_equal(
                np.asarray(loaded.transform(frame)["prediction"]),
                classes) or loaded_err > EST_ROW_TOL:
            raise AssertionError(f"leg A: the loaded model's rows differ "
                                 f"by {loaded_err}")
        del loaded
        shutil.rmtree(path, ignore_errors=True)

        # LocalEstimator: 2 steps on one batch; its loss on that batch,
        # without dropout (validate), before and after them
        le = LocalEstimator(model, "sparse_categorical_crossentropy",
                            optim_method=Adam(lr=TRAIN_LR), thread_num=8)
        xb, yb = [t[:TRAIN_BATCH] for t in x], y[:TRAIN_BATCH]
        le_before = le.validate(xb, yb, batch_size=TRAIN_BATCH)["loss"]
        le.fit(xb, yb, epoch=2, batch_size=TRAIN_BATCH)
        le_losses = list(le.trainer.step_losses)
        le_after = le.validate(xb, yb, batch_size=TRAIN_BATCH)["loss"]
        if len(le_losses) != 2 or not np.isfinite(le_losses).all() or \
                not le_after < le_before:
            raise AssertionError(f"LocalEstimator: steps {le_losses}, loss "
                                 f"{le_before} -> {le_after}")
        del le

        # the step through NNFrames (the frame's rows made into samples,
        # a new Estimator and trainer a fit) against Model.fit's
        model.compile(optimizer=Adam(lr=TRAIN_LR),
                      loss="sparse_categorical_crossentropy")
        timing = {"nnframes_fit": [], "model_fit": []}
        for w in range(EST_WINDOWS):
            order = (("nnframes_fit", lambda: clf.fit(frame)),
                     ("model_fit", lambda: model.fit(
                         x, y, batch_size=TRAIN_BATCH, nb_epoch=1)))
            for name, fit in order if w % 2 == 0 else order[::-1]:
                timing[name].append(est_fit_ms(fit))
    finally:
        cfg.compute_dtype, cfg.log_every_n_steps = saved
    return dict(
        model="BERT-base classifier (bench.py:353-438) under NNClassifier",
        frame=f"dict of columns, {EST_ROWS} rows of 512 int32 ids",
        compute_dtype="bfloat16", batch=TRAIN_BATCH, steps=EST_STEPS,
        losses=losses, launches=launches, launches_per_step=per_step,
        parity=dict(nnframes_loss=nn_loss, model_fit_loss=fit_loss,
                    rel=parity_rel, tol=EST_LOSS_TOL),
        transform_row_err=row_err, loaded_row_err=loaded_err,
        save_load_s=save_load_s, local_estimator_losses=le_losses,
        local_estimator_loss_before_after=[le_before, le_after],
        step_ms=timing,
        step_p50_ms={k: percentile(v, 50) for k, v in timing.items()},
        timed_windows=EST_WINDOWS), launches


def est_block_grads(fn, q, k, v, do):
    """dq, dk, dv of ``fn`` and the peak memory its forward and backward
    took above what was allocated before."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    node = out.grad_fn
    while type(node).__name__.startswith("Transpose"):
        node = node.next_functions[0][0]
    return grads, peak, seconds, type(node).__name__


def est_leg_b(seed, dev):
    """Leg B: a causal TransformerLayer at pythia-2.8b's attention width
    (d = 80), which the kernels decline: the blockwise backward."""
    b, l = BLK_BATCH, PYTHIA_CONFIG["seq_len"]
    h = PYTHIA_CONFIG["n_head"]
    d = PYTHIA_CONFIG["hidden_size"] // h
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, l, h, d, device=dev, generator=gen)
                   for _ in range(4))

    def tr(t):
        return t.transpose(1, 2)

    _kernels.LAUNCHES.reset()
    new, peak_new, s_new, node = est_block_grads(
        lambda q, k, v: attn.flash_attention_blhd(q, k, v, causal=True),
        q, k, v, do)
    if _kernels.LAUNCHES.snapshot() or "BlockwiseAttention" not in node:
        raise AssertionError(f"leg B: d = {d} ran {node}, launches "
                             f"{_kernels.LAUNCHES.snapshot()}")
    old, peak_old, s_old, _ = est_block_grads(
        lambda q, k, v: tr(attn._blockwise_fwd_impl(
            tr(q), tr(k), tr(v), None, True, scale,
            attn._fallback_block(l))[0]), q, k, v, do)
    ref, peak_ref, s_ref, _ = est_block_grads(
        lambda q, k, v: tr(attn.attention_reference(
            tr(q), tr(k), tr(v), causal=True)), q, k, v, do)
    errs = {name: float((g - r).abs().max() / max(1.0, r.abs().max()))
            for name, g, r in zip(("dq", "dk", "dv"), new, ref)}
    old_errs = {name: float((g - r).abs().max() / max(1.0, r.abs().max()))
                for name, g, r in zip(("dq", "dk", "dv"), old, ref)}
    if max(errs.values()) > BLK_TOL:
        raise AssertionError(f"leg B: the blockwise backward against the "
                             f"reference: {errs}")
    del new, old, ref, q, k, v, do
    collect()

    # fit: 2 steps of the 2-block trunk with a classifier head
    rs = np.random.default_rng(seed)
    tokens = rs.integers(1000, PYTHIA_CONFIG["vocab"], size=(b, l))
    labels = rs.integers(0, N_CLASSES, size=b)
    tokens[:, 0] = 101 + labels
    ins = L.Input(shape=(l,), name="tokens")
    _, pooled = L.TransformerLayer(**PYTHIA_CONFIG)(ins)
    model = Model(ins, L.Dense(N_CLASSES, activation="softmax")(pooled),
                  seed=seed)
    model.compile(optimizer=Adam(lr=TRAIN_LR),
                  loss="sparse_categorical_crossentropy")
    x, y = tokens.astype(np.float32), labels.astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=b, nb_epoch=BLK_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _kernels.LAUNCHES.snapshot()
    losses = list(model.trainer.step_losses)
    fit_peak = torch.cuda.max_memory_allocated()
    if launches or len(losses) != BLK_STEPS or \
            not np.isfinite(losses).all():
        raise AssertionError(f"leg B fit: launches {launches}, losses "
                             f"{losses}")
    return dict(
        model="causal TransformerLayer at EleutherAI pythia-2.8b's width "
              "(hidden 2560, 32 heads of d = 80, 2048 positions, vocab "
              "50304, intermediate 10240), 2 of 32 blocks, Dense(2) head",
        batch=b, seq_len=l, steps=BLK_STEPS, losses=losses,
        launches=launches, block_shape=[b, l, h, d],
        grad_err=errs, grad_tol=BLK_TOL, old_route_grad_err=old_errs,
        peak_bytes=dict(blockwise_function=peak_new,
                        autograd_through_forward=peak_old,
                        attention_reference=peak_ref),
        fwd_bwd_s=dict(blockwise_function=s_new,
                       autograd_through_forward=s_old,
                       attention_reference=s_ref),
        fit_s=fit_s, fit_peak_bytes=fit_peak,
        parameters=sum(p.numel() for p in model.parameters()))


def est_leg_c(seed, dev):
    """Leg C: bench.py's classifier under ``flash_remat="full"``: the
    backward differentiates through the reference attention."""
    cfg = zoo_nncontext.get_nncontext().config
    saved = cfg.flash_remat
    config = dict(BERT_CONFIG, hidden_p_drop=TRAIN_P_DROP,
                  attn_p_drop=TRAIN_P_DROP)
    x, y, _ = train_data(seed, TRAIN_BATCH)
    n_block = BERT_CONFIG["n_block"]
    want = {"": {attn.KERNEL_NAME: n_block, attn.DQ_KERNEL_NAME: n_block,
                 attn.DKV_KERNEL_NAME: n_block,
                 dln.FWD_KERNEL_NAME: 2 * n_block,
                 dln.BWD_KERNEL_NAME: 2 * n_block},
            "full": {attn.KERNEL_NAME: n_block,
                     dln.FWD_KERNEL_NAME: 2 * n_block,
                     dln.BWD_KERNEL_NAME: 2 * n_block}}
    try:
        model = build_classifier(seed, config)
        trainer = SPMDTrainer(model, get_loss(
            "sparse_categorical_crossentropy"), get_optimizer("adam"),
            device=dev)
        trainer.ensure_initialized()
        batch = trainer.put_batch((x, y, np.ones(TRAIN_BATCH, np.float32)))
        grads, step_launches, step_losses = {}, {}, {}
        for policy in ("", "full"):
            cfg.flash_remat = policy
            _kernels.LAUNCHES.reset()
            step_losses[policy] = trainer.loss_and_grads(batch).item()
            step_launches[policy] = _kernels.LAUNCHES.snapshot()
            grads[policy] = {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}
        if step_launches != want:
            raise AssertionError(f"leg C launches {step_launches}")
        worst, worst_name = 0.0, None
        for name, g in grads["full"].items():
            rel = _rel(g, grads[""][name])
            if rel > worst:
                worst, worst_name = rel, name
        if worst > REMAT_GRAD_TOL:
            raise AssertionError(f"leg C: {worst_name}'s gradient under "
                                 f"'full' is {worst} from the default's")
        del trainer, grads, batch
        collect()

        cfg.flash_remat = "full"
        model.compile(optimizer=Adam(lr=TRAIN_LR),
                      loss="sparse_categorical_crossentropy")
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        model.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=REMAT_STEPS)
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES.snapshot()
        losses = list(model.trainer.step_losses)
        if launches != {k: REMAT_STEPS * v for k, v in want["full"].items()
                        } or not np.isfinite(losses).all():
            raise AssertionError(f"leg C fit: launches {launches}, losses "
                                 f"{losses}")
        timing = {"lse": [], "full": []}
        peak = {"lse": 0, "full": 0}
        for w in range(EST_WINDOWS):        # alternating windows
            order = ("lse", "full") if w % 2 == 0 else ("full", "lse")
            for policy in order:
                cfg.flash_remat = policy
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                timing[policy] += io_step_ms(model, x, y)
                peak[policy] = max(peak[policy],
                                   torch.cuda.max_memory_allocated())
    finally:
        cfg.flash_remat = saved
    return dict(
        model="BERT-base classifier (bench.py:353-438), float32, dropout "
              "0.1, ZooConfig(flash_remat='full')",
        batch=TRAIN_BATCH, steps=REMAT_STEPS, losses=losses,
        launches=launches, launches_per_step=want["full"],
        step_launches_by_policy=step_launches,
        step_loss_by_policy=step_losses, max_grad_rel_err=worst,
        max_grad_rel_err_param=worst_name, grad_tol=REMAT_GRAD_TOL,
        step_p50_ms={k: 1e3 * percentile(v, 50) for k, v in timing.items()},
        step_ms={k: [1e3 * t for t in v] for k, v in timing.items()},
        peak_memory_bytes=peak, timed_windows=EST_WINDOWS), launches


def est_card_product(seed, hold_s=0.0):
    """A RayContext task on its worker's device: a seeded 256 x 256
    product left on the card, the worker's pid and when the task began."""
    began = time.time()
    dev = zoo_nncontext.get_nncontext().device
    a = torch.randn(256, 256, generator=torch.Generator().manual_seed(seed))
    a = a.to(dev)
    out = a @ a
    time.sleep(hold_s)
    return out, os.getpid(), began


class EstCardCounter:
    """A RayContext actor holding a running sum on its worker's device."""

    def __init__(self):
        self.total = torch.zeros(8, device=zoo_nncontext.get_nncontext()
                                 .device)

    def add(self, seed):
        self.total += torch.randn(8, generator=torch.Generator().manual_seed(
            seed)).to(self.total.device)
        return self.total.clone()


def est_claiming_segment(trial_id, config, budget, data, ckpt_dir,
                         start_epochs=0):
    """``run_trial_segment`` after a claim file naming this worker, so the
    phase can SIGKILL a worker while it trains a segment."""
    with open(os.path.join(ckpt_dir, f"claim-{os.getpid()}"), "w"):
        pass
    return run_trial_segment(trial_id, config, budget, data, ckpt_dir,
                             start_epochs)


def est_leg_d(seed, dev, root):
    """Leg D: RayContext on the card, then the AutoML smoke's contract
    with real LSTMForecasters and a SIGKILL."""
    t0 = time.perf_counter()
    wall0 = time.time()
    ctx = RayContext(num_ray_nodes=EST_WORKERS, ray_node_cpu_cores=1).init()
    workdir = os.path.join(root, "automl")
    os.makedirs(workdir, exist_ok=True)
    try:
        refs = [ctx.remote(est_card_product).remote(seed + i, 1.0)
                for i in range(2 * EST_WORKERS)]
        products = ctx.get(refs, timeout=EST_WAIT_S)
        first = time.perf_counter() - t0
        start_s = {}
        for i, (out, pid, began) in enumerate(products):
            a = torch.randn(256, 256, generator=torch.Generator()
                            .manual_seed(seed + i)).to(dev)
            if out.device != dev or not torch.allclose(
                    out, a @ a, rtol=1e-6, atol=1e-5):
                raise AssertionError(f"leg D: task {i}'s product on "
                                     f"{out.device} differs")
            start_s[pid] = min(start_s.get(pid, math.inf), began - wall0)
        if len(start_s) != EST_WORKERS:
            raise AssertionError(f"leg D: tasks ran on {sorted(start_s)}")
        counter = ctx.remote(EstCardCounter).remote()
        sums = ctx.get([counter.add.remote(seed + i) for i in range(3)],
                       timeout=EST_WAIT_S)
        want = torch.zeros(8)
        for i, got in enumerate(sums):
            want += torch.randn(8, generator=torch.Generator().manual_seed(
                seed + i))
            if got.device != dev or not torch.allclose(got.cpu(), want,
                                                       atol=1e-6):
                raise AssertionError(f"leg D: the actor's sum {i}")
        ctx.kill(counter)

        # the AutoML smoke's contract with real forecasters
        t = np.arange(EST_SERIES, dtype=np.float32)
        rs = np.random.default_rng(seed)
        series = (np.sin(2 * np.pi * t / 24) + 0.05 * rs.standard_normal(
            EST_SERIES)).astype(np.float32)
        x, yy = rolling_window(series, EST_LOOKBACK, 1)
        (xt, yt), (xv, yv) = train_val_split(x, yy, 0.2)
        space = {"model": "lstm",
                 "lstm_units": Choice([(16,), (32,), (32, 16)]),
                 "dropout": Uniform(0.0, 0.2), "lr": Choice([1e-2, 3e-3]),
                 "batch_size": 32}
        cfg_rs = np.random.default_rng(seed)
        configs = [sample_config(space, cfg_rs) for _ in range(EST_TRIALS)]
        victim = ctx._procs[0].pid
        killed = []

        def kill_on_claim():
            claim = os.path.join(workdir, f"claim-{victim}")
            deadline = time.time() + EST_WAIT_S
            while not os.path.exists(claim) and time.time() < deadline:
                time.sleep(0.02)
            os.kill(victim, signal.SIGKILL)
            killed.append(victim)

        killer = threading.Thread(target=kill_on_claim, daemon=True)
        killer.start()
        scheduler = AshaScheduler(max_epochs=9, min_epochs=1,
                                  reduction_factor=3)
        executor = AsyncTrialExecutor(scheduler, ray_ctx=ctx,
                                      max_concurrent=EST_WORKERS,
                                      trial_fn=est_claiming_segment,
                                      workdir=workdir)
        t1 = time.perf_counter()
        trials = executor.run(configs, (xt, yt, xv, yv))
        search_s = time.perf_counter() - t1
        killer.join(timeout=EST_WAIT_S)
    finally:
        ctx.stop()
    stats = executor.stats
    best = min((tr["val_loss"] for tr in trials
                if tr["val_loss"] is not None and
                math.isfinite(tr["val_loss"])), default=float("nan"))
    checks = {"killed": killed == [victim],
              "requeued_exactly_once": stats["requeued"] == 1 and
              sum(tr["requeues"] for tr in trials) == 1,
              "finalized": stats["finalized"] == EST_TRIALS,
              "nothing_failed": stats["failed"] == 0,
              "early_stopped": stats["stopped"] > 0,
              "best_finite": math.isfinite(best)}
    if not all(checks.values()):
        raise AssertionError(f"leg D: {checks}, stats {stats}")
    return dict(
        workers=EST_WORKERS, platform="cuda (the default)",
        worker_start_s=sorted(start_s.values()),
        first_results_s=first, trials=EST_TRIALS,
        rungs=scheduler.rungs(), search_s=search_s,
        trial_seconds=[tr["seconds"] for tr in trials],
        trial_states=[tr["state"] for tr in trials],
        trial_epochs=[tr["epochs"] for tr in trials],
        best_val_loss=best, stats={k: v for k, v in stats.items()
                                   if k != "worker_pids"},
        checks=checks)


def estimators_phase(seed, dev, smi):
    """The estimators phase: A nnframes and LocalEstimator, B the blockwise
    backward at pythia-2.8b's width, C the ``full`` remat policy, D
    RayContext and AutoML on the card. Returns the report and K1-K5's
    launches in leg A's NNFrames fit and in leg C's fit."""
    t0 = time.perf_counter()
    shutil.rmtree(EST_ROOT, ignore_errors=True)
    os.makedirs(EST_ROOT)
    seconds = {}
    leg_a, launches = est_leg_a(seed + 80, EST_ROOT)
    seconds["a"] = time.perf_counter() - t0
    collect()
    leg_b = est_leg_b(seed + 81, dev)
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    collect()
    leg_c, remat_launches = est_leg_c(seed + 82, dev)
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    collect()
    leg_d = est_leg_d(seed + 83, dev, EST_ROOT)
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    shutil.rmtree(EST_ROOT, ignore_errors=True)
    return dict(card=smi, leg_a_nnframes=leg_a, leg_b_blockwise=leg_b,
                leg_c_remat_full=leg_c, leg_d_ray_automl=leg_d,
                leg_seconds=seconds,
                clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu"),
                wall_s=time.perf_counter() - t0), launches, remat_launches


# ---------------------------------------------------------------------------
# 22. text: tfpark's BERT estimators, the NER tagger, TFDataset and the GAN
# ---------------------------------------------------------------------------

# leg A: BERTClassifier at bench.py's width (bench.py:353-354), fed by
# bert_input_fn: 128 rows of 512 int32 ids with a padding input_mask,
# batch 32, Adam 1e-4; one float32 step (dropout off) held to Model.fit's
# on the same network, weights and ids; then 4 bf16 steps (dropout 0.1),
# evaluate, predict; both steps timed in TEXT_WINDOWS alternating
# windows. BERTNER (CoNLL-2003's 9 tags) and BERTSQuAD at 4 of the 12
# blocks for one bf16 step each.
TEXT_ROWS = 128
TEXT_STEPS = TEXT_ROWS // TRAIN_BATCH
TEXT_LOSS_TOL = 1e-6
TEXT_WINDOWS = 2
TEXT_HEAD_BLOCKS = 4
TEXT_NER_TAGS = 9
# leg B: NER at nlp_architect's NERCRF defaults (word embedding 100, char
# embedding 30, tagger LSTMs 100, 12 characters a word), crf_mode="pad",
# on CoNLL-2003-like batches: 32 sentences of 4-64 words a batch over a
# vocabulary of 20,000 words and 96 characters; 2 float32 steps, then
# predict_tags against the port's CPU run of the same weights and inputs;
# TEXT_NER_TIMED more steps timed one at a time, one of them profiled
TEXT_NER_KW = dict(num_entities=TEXT_NER_TAGS, word_vocab_size=20000,
                   char_vocab_size=96, word_length=12, word_emb_dim=100,
                   char_emb_dim=30, tagger_lstm_dim=100, crf_mode="pad")
TEXT_NER_LEN, TEXT_NER_BATCH, TEXT_NER_STEPS = 64, 32, 2
TEXT_NER_TIMED = 3
# leg C: tests/test_tfpark.py's 1-D Gaussian (N(3, 0.5), 512 rows), 150
# steps at batch 64 through TFDataset.from_ndarrays; the generated mean
# within 1.0 of 3.0; TEXT_GAN_TIMED single steps timed
TEXT_GAN_STEPS, TEXT_GAN_BATCH, TEXT_GAN_TIMED = 150, 64, 10


def text_features(x):
    """bench.py's classifier input as bert_input_fn's feature dict."""
    return {"input_ids": x[0], "input_mask": x[3][:, 0, 0, :],
            "token_type_ids": x[2]}


def text_classifier(blocks=None, dropout=True):
    """BERTClassifier(num_classes=2) at bench.py's width, Adam 1e-4."""
    cfg = BERT_CONFIG
    est = BERTClassifier(
        num_classes=N_CLASSES, vocab_size=cfg["vocab"],
        hidden_size=cfg["hidden_size"],
        n_block=blocks or cfg["n_block"], n_head=cfg["n_head"],
        seq_length=cfg["seq_len"],
        intermediate_size=cfg["intermediate_size"],
        optimizer=Adam(lr=TRAIN_LR))
    if not dropout:
        est.bert.hidden_p_drop = est.bert.attn_p_drop = 0.0
    return est


def text_per_step(blocks):
    return {attn.KERNEL_NAME: blocks, attn.DQ_KERNEL_NAME: blocks,
            attn.DKV_KERNEL_NAME: blocks, dln.FWD_KERNEL_NAME: 2 * blocks,
            dln.BWD_KERNEL_NAME: 2 * blocks}


def text_check_launches(what, launches, steps, blocks):
    want = {k: steps * v for k, v in text_per_step(blocks).items()}
    dtypes = _kernels.LAUNCHES.by_dtype()
    if launches != want or any(set(v) != {"bfloat16"}
                               for v in dtypes.values()):
        raise AssertionError(f"text {what}: launches {dtypes}, want {want}")


def text_leg_a(seed):
    """Leg A: the BERT estimators at bench.py's width (see TEXT_ROWS)."""
    cfg = zoo_nncontext.get_nncontext().config
    saved = (cfg.compute_dtype, cfg.log_every_n_steps)
    x, y, _ = train_data(seed, TEXT_ROWS, ids=np.int32)
    feats = text_features(x)
    y = y.astype(np.int32)
    try:
        cfg.log_every_n_steps = 1
        # the float32 step, dropout off, against Model.fit's on a copy of
        # the same network (weights as built) and the same ids
        cfg.compute_dtype = "float32"
        est = text_classifier(dropout=False)
        ref = copy.deepcopy(est.model)
        ref.compile(optimizer=Adam(lr=TRAIN_LR),
                    loss="sparse_categorical_crossentropy")
        one = bert_input_fn({k: v[:TRAIN_BATCH] for k, v in feats.items()},
                            y[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
        est.train(one, steps=1)
        est_loss = est.model.trainer.step_losses[0]
        ref.fit(list(one()[0].features), y[:TRAIN_BATCH],
                batch_size=TRAIN_BATCH, nb_epoch=1)
        fit_loss = ref.trainer.step_losses[0]
        parity_rel = abs(est_loss - fit_loss) / abs(fit_loss)
        if not parity_rel <= TEXT_LOSS_TOL:
            raise AssertionError(f"text leg A: the estimator's float32 "
                                 f"loss {est_loss} against Model.fit's "
                                 f"{fit_loss}")
        del est, ref
        collect()

        # 4 bf16 steps, dropout 0.1: K1-K5 12/12/12/24/24 a step
        cfg.compute_dtype = "bfloat16"
        est = text_classifier()
        data = bert_input_fn(feats, y, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        est.train(data, steps=TEXT_STEPS)
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES.snapshot()
        text_check_launches("BERTClassifier's train", launches, TEXT_STEPS,
                            BERT_CONFIG["n_block"])
        losses = list(est.model.trainer.step_losses)
        if len(losses) != TEXT_STEPS or not np.isfinite(losses).all() or \
                est.model.trainer.step != TEXT_STEPS:
            raise AssertionError(f"text leg A: losses {losses}")
        metrics = est.evaluate(data, metrics=["accuracy"])
        if set(metrics) != {"loss", "accuracy"} or \
                not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"text leg A: evaluate gave {metrics}")
        rows = est.predict(bert_input_fn(feats, batch_size=TRAIN_BATCH))
        want = est.model.predict(x, batch_size=TRAIN_BATCH)
        row_err = float(np.abs(rows - want).max())
        if rows.shape != (TEXT_ROWS, N_CLASSES) or row_err > 0.0 or \
                not np.isfinite(rows).all():
            raise AssertionError(f"text leg A: predict's rows {rows.shape} "
                                 f"off Model.predict's by {row_err}")

        # the estimator's steps against Model.fit's on the same model
        timing = {"estimator_train": [], "model_fit": []}
        for w in range(TEXT_WINDOWS):
            order = (("estimator_train",
                      lambda: est.train(data, steps=TEXT_STEPS)),
                     ("model_fit", lambda: est.model.fit(
                         x, y, batch_size=TRAIN_BATCH, nb_epoch=1)))
            for name, fit in order if w % 2 == 0 else order[::-1]:
                timing[name].append(est_fit_ms(fit, TEXT_STEPS))
        del est
        collect()

        # BERTNER and BERTSQuAD at 4 of 12 blocks, one bf16 step each
        heads, head_launches = {}, {}
        rs = np.random.default_rng(seed + 1)
        l = BERT_CONFIG["seq_len"]
        tags = rs.integers(0, TEXT_NER_TAGS, (TRAIN_BATCH, l)).astype(
            np.int32)
        spans = np.sort(rs.integers(0, l, (2, TRAIN_BATCH)), axis=0)
        first = {k: v[:TRAIN_BATCH] for k, v in feats.items()}
        cases = (("BERTNER", BERTNER, dict(num_entities=TEXT_NER_TAGS),
                  tags, [(TRAIN_BATCH, l, TEXT_NER_TAGS)]),
                 ("BERTSQuAD", BERTSQuAD, {},
                  [spans[0].astype(np.int32), spans[1].astype(np.int32)],
                  [(TRAIN_BATCH, l), (TRAIN_BATCH, l)]))
        for name, cls, extra, labels, shapes in cases:
            c = BERT_CONFIG
            est = cls(vocab_size=c["vocab"], hidden_size=c["hidden_size"],
                      n_block=TEXT_HEAD_BLOCKS, n_head=c["n_head"],
                      seq_length=l, intermediate_size=c["intermediate_size"],
                      optimizer=Adam(lr=TRAIN_LR), **extra)
            torch.cuda.synchronize()
            _kernels.LAUNCHES.reset()
            est.train(bert_input_fn(first, labels, batch_size=TRAIN_BATCH),
                      steps=1)
            torch.cuda.synchronize()
            head_launches[name] = _kernels.LAUNCHES.snapshot()
            text_check_launches(f"{name}'s step", head_launches[name], 1,
                                TEXT_HEAD_BLOCKS)
            out = est.predict(bert_input_fn(first, batch_size=TRAIN_BATCH))
            outs = out if isinstance(out, list) else [out]
            if [o.shape for o in outs] != shapes or \
                    not all(np.isfinite(o).all() for o in outs):
                raise AssertionError(f"text leg A: {name} predicted "
                                     f"{[o.shape for o in outs]}")
            heads[name] = dict(loss=est.model.trainer.step_losses[0],
                               launches=head_launches[name],
                               output_shapes=[list(o.shape) for o in outs])
            del est
            collect()
    finally:
        cfg.compute_dtype, cfg.log_every_n_steps = saved
    summed = {}
    for v in head_launches.values():
        for k, n in v.items():
            summed[k] = summed.get(k, 0) + n
    return dict(
        model="BERTClassifier(num_classes=2) at bench.py's width "
              "(bench.py:353-354) through bert_input_fn",
        rows=TEXT_ROWS, batch=TRAIN_BATCH, steps=TEXT_STEPS,
        compute_dtype="bfloat16", losses=losses, launches=launches,
        launches_per_step=text_per_step(BERT_CONFIG["n_block"]),
        parity=dict(estimator_loss=est_loss, model_fit_loss=fit_loss,
                    rel=parity_rel, tol=TEXT_LOSS_TOL),
        evaluate=metrics, predict_row_err=row_err, step_ms=timing,
        step_p50_ms={k: percentile(v, 50) for k, v in timing.items()},
        timed_windows=TEXT_WINDOWS, heads_blocks=TEXT_HEAD_BLOCKS,
        heads=heads), launches, summed


def text_ner_data(seed, n):
    """CoNLL-2003-like batches: sentence lengths 4-64, words and their
    characters (1-12 a word) as ids, 0 past each end; IOB-like tags."""
    rs = np.random.default_rng(seed)
    kw, l = TEXT_NER_KW, TEXT_NER_LEN
    lens = rs.integers(4, l + 1, n)
    real = np.arange(l)[None] < lens[:, None]
    words = np.where(real, rs.integers(1, kw["word_vocab_size"], (n, l)), 0)
    wl = kw["word_length"]
    nchars = rs.integers(1, wl + 1, (n, l))
    chars = rs.integers(1, kw["char_vocab_size"], (n, l, wl))
    chars = np.where((np.arange(wl)[None, None] < nchars[..., None]) &
                     real[..., None], chars, 0)
    tags = np.where(real, rs.integers(0, kw["num_entities"], (n, l)), 0)
    return ([words.astype(np.int32), chars.astype(np.int32),
             lens.astype(np.int32)], tags.astype(np.int32))


def text_leg_b(seed):
    """Leg B: NER at NERCRF's defaults, float32, K1-K5 launched 0 times."""
    cfg = zoo_nncontext.get_nncontext().config
    saved = cfg.compute_dtype
    try:
        cfg.compute_dtype = "float32"
        n = TEXT_NER_BATCH * TEXT_NER_STEPS
        x, tags = text_ner_data(seed, n)
        ner = NER(**TEXT_NER_KW, optimizer=Adam(lr=1e-3))
        torch.cuda.synchronize()
        _kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        ner.fit(x, tags, batch_size=TEXT_NER_BATCH, epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        losses = list(ner.model.trainer.step_losses)
        if len(losses) != TEXT_NER_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"text leg B: losses {losses}")
        got = ner.predict_tags(x, batch_size=TEXT_NER_BATCH)
        launches = no_launches("text leg B (NER)")
        cpu = cpu_twin(ner.model)
        outs = cpu.trainer.predict(x, batch_size=TEXT_NER_BATCH)
        want = NER._decode_outputs(outs)
        margins = viterbi_margins(torch.as_tensor(outs[0]),
                                  torch.as_tensor(outs[1][0]),
                                  torch.as_tensor(outs[2]))
        differ = int((got != want).any(-1).sum())
        if got.shape != (n, TEXT_NER_LEN) or differ:
            raise AssertionError(
                f"text leg B: {differ} sentences' tags differ from the "
                f"CPU's (smallest Viterbi margin {float(margins.min())})")
        lens = x[2]
        if any(got[i, lens[i]:].any() for i in range(n)):
            raise AssertionError("text leg B: tags past a sentence's end")
        del cpu
        # single steps timed (one batch a fit), one profiled
        xb, yb = [a[:TEXT_NER_BATCH] for a in x], tags[:TEXT_NER_BATCH]

        def step():
            ner.model.fit(xb, yb, batch_size=TEXT_NER_BATCH, nb_epoch=1)
            torch.cuda.synchronize()

        times = []
        for _ in range(TEXT_NER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            times.append(1e3 * (time.perf_counter() - t0))
        _kernels.LAUNCHES.reset()
        prof = profile_device(step)
        no_launches("text leg B's profiled step")
        del ner
        collect()
    finally:
        cfg.compute_dtype = saved
    return dict(
        model="NER (nlp_architect NERCRF defaults: word 100, char 30, "
              "tagger 100, 12 chars a word), crf_mode='pad'",
        config=TEXT_NER_KW, batch=TEXT_NER_BATCH, max_len=TEXT_NER_LEN,
        losses=losses, fit_s=fit_s, sentences=n, tags_equal_cpu=True,
        min_viterbi_margin=float(margins.min()), step_ms=times,
        step_p50_ms=percentile(times, 50),
        launches_per_step=0, launches=launches, profile=prof)


def text_leg_c(seed, dev):
    """Leg C: GANEstimator on the 1-D Gaussian through TFDataset."""
    rs = np.random.default_rng(seed)
    real = (rs.standard_normal((512, 1)) * 0.5 + 3.0).astype(np.float32)

    def mlp(in_dim):
        m = Sequential(seed=seed)
        m.add(L.Dense(16, activation="relu", input_shape=(in_dim,)))
        m.add(L.Dense(1))
        return m

    est = GANEstimator(mlp(4), mlp(1), generator_optimizer=Adam(lr=5e-3),
                       discriminator_optimizer=Adam(lr=5e-3), noise_dim=4,
                       seed=seed)
    data = TFDataset.from_ndarrays(real, batch_size=TEXT_GAN_BATCH)
    _kernels.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.train(data, steps=TEXT_GAN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if est.device != dev or any(p.device != dev for m in (
            est.generator, est.discriminator) for p in m.parameters()):
        raise AssertionError(f"text leg C: the GAN is not on {dev}")
    samples = est.generate(256)
    mean = float(samples.mean())
    if samples.shape != (256, 1) or not abs(mean - 3.0) < 1.0:
        raise AssertionError(f"text leg C: generated mean {mean}")
    times = []
    for _ in range(TEXT_GAN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train(data, steps=1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = no_launches("text leg C (GAN)")
    return dict(model="GANEstimator: Dense(16, relu) -> Dense(1) each "
                      "side, noise 4, Adam 5e-3 (tests/test_tfpark.py)",
                steps=TEXT_GAN_STEPS, batch=TEXT_GAN_BATCH, train_s=train_s,
                generated_mean=mean, last_losses=est.last_losses,
                step_ms=times, step_p50_ms=percentile(times, 50),
                launches=launches)


def text_phase(seed, dev, smi):
    """The text phase: A the BERT estimators, B NER, C the GAN through
    TFDataset. Returns the report, K1-K5's launches in leg A's 4 bf16
    BERTClassifier steps and in the BERTNER and BERTSQuAD steps."""
    t0 = time.perf_counter()
    seconds = {}
    leg_a, launches, head_launches = text_leg_a(seed + 90)
    seconds["a"] = time.perf_counter() - t0
    leg_b = text_leg_b(seed + 91)
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    leg_c = text_leg_c(seed + 92, dev)
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    return dict(card=smi, device=str(dev), leg_a_bert_estimators=leg_a,
                leg_b_ner=leg_b, leg_c_gan=leg_c, leg_seconds=seconds,
                clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                  "temperature.gpu"),
                wall_s=time.perf_counter() - t0), launches, head_launches


class PhaseClock:
    """Seconds of each phase of ``main``, host clock between marks (the
    ``phases`` line: where the script's time limit goes)."""

    def __init__(self):
        self.seconds = {}
        self._name, self._t = None, time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        if self._name is not None:
            self.seconds[self._name] = now - self._t
        self._name, self._t = name, now


# Every process a run starts inherits RUN_MARK in its environment, set by
# the run's top-level process. At the end each process of the script reaps
# its own multiprocessing resource tracker (left to itself, the tracker
# exits only after its parent, and its zombie then waits on the machine's
# init, which may reap it seconds later), and the top-level process stops
# and names whatever still carries the mark.
RUN_MARK = "CHIP_SMOKE_RUN"
STOP_GRACE_S = 5.0


def own_run():
    """Mark the environment this process hands its children, unless a
    parent run did; True where this process owns the run."""
    if os.environ.get(RUN_MARK):
        return False
    os.environ[RUN_MARK] = f"{os.getpid()}.{time.time_ns()}"
    return True


def run_strays():
    """(pid, command line) of the live processes, other than this one,
    whose environment carries this run's mark."""
    mark = f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    strays = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        strays.append((int(name), cmd.strip()))
    return strays


def reap_children():
    """Collect every child of this process that has exited."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_resource_tracker():
    """Run multiprocessing's exit hook now (daemonic children stopped,
    semaphores unregistered), then close this process's end of its
    resource tracker's pipe and reap the tracker: it is this process's
    child and exits at the pipe's end."""
    from multiprocessing import resource_tracker, util
    util._exit_function()
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        fd, pid = tracker._fd, tracker._pid
        if fd is None:
            return
        os.close(fd)
        tracker._fd = tracker._pid = None
    if pid is None:
        return
    deadline = time.time() + STOP_GRACE_S
    while os.waitpid(pid, os.WNOHANG)[0] == 0:
        if time.time() > deadline:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            return
        time.sleep(0.02)


def stop_strays():
    """SIGTERM, then SIGKILL, every live process of this run but this
    one; waits until they are gone and returns what it found."""
    strays = run_strays()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in run_strays():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.time() + STOP_GRACE_S
        while run_strays() and time.time() < deadline:
            reap_children()
            time.sleep(0.05)
    # a killed orphan's zombie belongs to init: wait until init reaped it
    deadline = time.time() + STOP_GRACE_S
    while time.time() < deadline and any(
            os.path.exists(f"/proc/{pid}") for pid, _ in strays):
        reap_children()
        time.sleep(0.05)
    return strays


def finish_run(owner):
    """Leave no process of the run behind: this process's resource
    tracker reaped, and where it owns the run every other process of it
    stopped (named on stderr: a phase left it running)."""
    stop_resource_tracker()
    if owner:
        strays = stop_strays()
        if strays:
            print(f"chip_smoke.py: stopped {len(strays)} process(es) that "
                  f"outlived their phase: {strays}", file=sys.stderr,
                  flush=True)
    reap_children()


def one_phase(name, seed, ranks):
    """``--phase NAME``: ``main``'s set-up (the kernels built, the context
    on the card, TF32 off), then that phase alone. Its report goes to
    ``chiprun_out/<name>_report[_<ranks>].json`` and, as a line, to the
    output; the last line holds the phase's seconds and K1-K5 launches.
    ``--ranks`` sets the ranks of the parallel legs B-G: two share one
    card over gloo; on a machine with that many cards each rank has its
    own, over NCCL (at four, legs D-G run tp = pp = ep = dp = 4)."""
    global PAR_RANKS
    PAR_RANKS = ranks
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    _kernels.library()
    init_nncontext()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if name == "interop":
        report, launches = interop_phase(seed, dev, smi)
    elif name == "estimators":
        report, est, remat = estimators_phase(seed, dev, smi)
        launches = dict(estimators=est, remat_full=remat)
    elif name == "text":
        report, text, heads = text_phase(seed, dev, smi)
        launches = dict(text=text, text_heads=heads)
    elif name == "fleet":
        report, launches = fleet_phase(seed, dev, smi)
    elif name == "parallel":
        report, launches = parallel_phase(seed, dev, smi)
    else:
        report, launches = layout_phase(seed, smi)
    seconds = time.perf_counter() - t0
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    suffix = "" if ranks == PAR_SHARDS else f"_{ranks}"
    with open(os.path.join(out, f"{name}_report{suffix}.json"), "w") as f:
        json.dump(report, f, indent=1)
    emit(name, **report)
    print(json.dumps({"phase": name, "seconds": seconds,
                      "launches": launches}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, requests, training data "
                         "and kernel inputs")
    ap.add_argument("--phase", choices=("interop", "estimators", "text",
                                        "fleet", "parallel", "layout"),
                    default=None,
                    help="build the kernels, then run this phase alone "
                         "(``layout``: the parallel phase's legs D-G)")
    ap.add_argument("--ranks", type=int, default=PAR_SHARDS,
                    help="with --phase parallel or layout: the ranks of "
                         "legs B-G")
    ap.add_argument("--parallel-worker",
                    choices=("a", "a_resume", "bc", "layout"),
                    default=None,
                    help="run one rank of a leg of the parallel phase (the "
                         "phase starts these through the launcher)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is visible; it runs on the "
                 "GPU only")
    if args.parallel_worker is not None:
        parallel_worker(args.parallel_worker, args.seed)
        return
    if args.phase is not None:
        one_phase(args.phase, args.seed, args.ranks)
        return

    clock = PhaseClock()
    clock.mark("device")
    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda)
    print(smi, flush=True)

    clock.mark("build")
    # 2. build
    t0 = time.perf_counter()
    _kernels.library()
    wall = time.perf_counter() - t0
    sass = _kernels.sass_opcode_counts(_kernels.BUILD_INFO["library"])
    emit("build", wall_s=wall, tensor_core_instructions=sass,
         **_kernels.BUILD_INFO)
    check_tensor_cores(sass)

    clock.mark("kernels")
    # 3. kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fwd_err = check_forward(dev, args.seed)
    bwd_err = check_backward(dev, args.seed)
    check_autograd(dev, args.seed)
    dln_err = check_dln(dev, args.seed)

    clock.mark("serve")
    # 4. serve
    ctx = init_nncontext()
    if ctx.device != dev:
        raise AssertionError(f"init_nncontext() chose {ctx.device}")
    t0 = time.perf_counter()
    model = build_classifier(args.seed)
    cpu_model = copy.deepcopy(model)
    build_s = time.perf_counter() - t0
    im = InferenceModel(supported_concurrent_num=CLIENTS).load_keras_net(
        model)
    l = BERT_CONFIG["seq_len"]
    warm = im.warm([(l,), (l,), (l,), (1, 1, l)], [BATCH])
    requests, real_tokens = make_requests(args.seed, REQUESTS, BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.LAUNCHES.reset()
    outputs, latency, wall = serve(im, requests, CLIENTS)
    serve_launches = _kernels.LAUNCHES.snapshot()
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = BERT_CONFIG["n_block"] * REQUESTS
    if serve_launches != {attn.KERNEL_NAME: expected}:
        raise AssertionError(f"launches {serve_launches}, expected "
                             f"{{{attn.KERNEL_NAME!r}: {expected}}}")
    row_sum_err = check_outputs(outputs, BATCH)
    cpu_err = check_cpu_row(cpu_model, requests[0], outputs[0][0])
    del cpu_model
    emit("serve", model="BERT-base classifier (bench.py:353-438)",
         config=BERT_CONFIG, seed=args.seed, requests=REQUESTS,
         batch=BATCH, clients=CLIENTS, real_tokens=real_tokens,
         padded_tokens=REQUESTS * BATCH * l, build_s=build_s,
         warm_s=warm[BATCH], launches=serve_launches,
         launches_expected=expected, max_row_sum_err=row_sum_err,
         row_sum_tol=ROW_SUM_TOL, cpu_row_max_abs_err=cpu_err,
         cpu_tol=CPU_TOL,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         wall_s=wall, latency_s=latency, peak_memory_bytes=peak_bytes)

    clock.mark("train")
    # 5. train, in float32 and then in bf16
    trained, train_report = train(args.seed)
    train_launches = train_report["launches"]
    emit("train", **train_report)
    emit("train_parity", **check_train_parity(args.seed, dev))
    trained_bf16, bf16_report = train(args.seed, "bfloat16")
    bf16_report["parity"] = check_train_parity(args.seed, dev, "bfloat16")
    bf16_report["timing"] = time_train_dtypes(
        {"float32": trained, "bfloat16": trained_bf16}, args.seed)
    emit("train_bf16", card=smi, **bf16_report)

    clock.mark("timing")
    # 6. timing
    timed = [requests[i % REQUESTS] for i in range(TIMED_REQUESTS)]
    _, t_latency, t_wall = serve(im, timed, CLIENTS)
    kern = {dt: time_kernel(dev, args.seed, dt)
            for dt in (torch.float32, torch.bfloat16)}
    emit("timing", path="serve", card=smi, requests=TIMED_REQUESTS,
         batch=BATCH, clients=CLIENTS,
         latency_p50_ms=1e3 * percentile(t_latency, 50),
         latency_p95_ms=1e3 * percentile(t_latency, 95),
         padded_tokens_per_s=TIMED_REQUESTS * BATCH * l / t_wall,
         real_tokens_per_s=real_tokens * TIMED_REQUESTS / REQUESTS / t_wall,
         wall_s=t_wall, peak_memory_bytes=peak_bytes,
         flash_fwd=list(kern.values()),
         clocks=nvidia_smi("clocks.sm,power.draw,power.limit,"
                           "temperature.gpu"),
         profile=profile_device(lambda: im.predict(requests[0])))
    emit("timing", path="train", card=smi, **time_training(trained,
                                                           args.seed))
    train_kern = {dt: time_training_kernels(dev, args.seed, dt)
                  for dt in (torch.float32, torch.bfloat16)}
    for dt, rows in train_kern.items():
        emit("timing", path="kernels at the training shape", card=smi,
             dtype=dtype_name(dt), shape=dict(B=TRAIN_SHAPE[0],
                                              L=TRAIN_SHAPE[1],
                                              H=TRAIN_SHAPE[2],
                                              d=TRAIN_SHAPE[3],
                                              N=DLN_SHAPE[0],
                                              D=DLN_SHAPE[1]),
             kernels=rows)

    clock.mark("generate")
    # 7. generate, after the served and trained models' memory is freed
    # (their graphs hold reference cycles, so collect them first)
    del trained, trained_bf16, im, model
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches, prefill_k1 = generate(args.seed, dev, smi)

    clock.mark("ncf")
    # 8. NeuralCF
    emit("ncf", card=smi, **ncf(args.seed, dev))

    clock.mark("checkpoint")
    # 9. checkpoint, after the generation and NCF models are freed
    collect()
    ckpt_report, accum_launches = checkpoint(args.seed, dev, smi, CKPT_ROOT)
    emit("checkpoint", **ckpt_report)

    clock.mark("sequence")
    # 10. the sequence models
    collect()
    seq_report, seq_launches = sequence(args.seed, smi)
    emit("sequence", **seq_report)

    clock.mark("resnet")
    # 11. ResNet-50
    collect()
    resnet(args.seed, dev, smi)

    clock.mark("cluster_serving")
    # 12. Cluster Serving
    collect()
    cs_launches = cluster_serving(args.seed, dev, smi)

    clock.mark('int8')
    # 13. int8 inference
    collect()
    int8_report, int8_launches = int8_phase(args.seed, dev, smi)
    emit("int8", **int8_report)

    clock.mark("fleet")
    # 14. the fleet: the CLI, the socket broker and the shard fabric
    collect()
    fleet_report, fleet_launches = fleet_phase(args.seed, dev, smi)
    emit("fleet", check="phase", ok=True, wall_s=fleet_report["wall_s"],
         leg_seconds=fleet_report["leg_seconds"],
         launches=fleet_launches, card=smi, timing=dict(
             leg_a_records_per_s=fleet_report["leg_a"]["records_per_s"],
             leg_b_clean_records_per_s=fleet_report["leg_b"][
                 "clean_records_per_s"],
             socket_ceiling_records_per_s=fleet_report["ceiling"][
                 "records_per_s"],
             leg_c_records_per_s=fleet_report["leg_c"]["records_per_s"],
             worker_start_s=fleet_report["leg_b"]["worker_start_s"],
             restarted_worker_start_s=fleet_report["leg_b"][
                 "restarted_worker_start_s"]))

    clock.mark("observe")
    # 15. observe: the health monitor, the memory accountant, MFU
    collect()
    obs_report, obs_launches = observe(args.seed, smi)
    emit("observe", **obs_report)

    clock.mark("data")
    # 16. data: the host data layer feeding BERT-base and ResNet-50
    collect()
    data_report, data_launches = data(args.seed, smi)
    emit("data", **data_report)

    clock.mark("detect")
    # 17. detect: image features without OpenCV and SSD-300
    collect()
    detect_report, detect_launches = detect_phase(args.seed, smi)
    emit("detect", **detect_report)

    clock.mark("layers")
    # 18. layers: the MoE transformer and the rest of the layer library
    collect()
    layers_report, layers_launches = layers_phase(args.seed, dev, smi)
    emit("layers", **layers_report)

    clock.mark("interop")
    # 20. interop: ResNet-50 from ONNX and Caffe, BERT-base with a
    # PyTorch head
    collect()
    interop_report, interop_launches = interop_phase(args.seed, dev, smi)
    emit("interop", **interop_report)

    clock.mark("estimators")
    # 21. estimators: nnframes and LocalEstimator, the attention backward's
    # other routes, RayContext and AutoML
    collect()
    est_report, est_launches, remat_launches = estimators_phase(
        args.seed, dev, smi)
    emit("estimators", **est_report)

    clock.mark("text")
    # 22. text: tfpark's BERT estimators, the NER tagger, TFDataset and the
    # GAN
    collect()
    text_report, text_launches, text_head_launches = text_phase(
        args.seed, dev, smi)
    emit("text", **text_report)

    clock.mark("parallel")
    # 19. parallel: data, sequence, tensor, pipeline and expert
    # parallelism and FSDP through the launcher
    collect()
    parallel_report, parallel_launches = parallel_phase(args.seed, dev, smi)
    emit("parallel", **parallel_report)

    clock.mark(None)
    emit("phases", seconds=clock.seconds)

    f32 = train_kern[torch.float32]
    bf = train_kern[torch.bfloat16]
    bf16_launches = bf16_report["launches"]
    errs = {attn.KERNEL_NAME: fwd_err[torch.float32],
            attn.DQ_KERNEL_NAME: bwd_err[torch.float32]["dq"],
            attn.DKV_KERNEL_NAME: bwd_err[torch.float32]["dkv"],
            dln.FWD_KERNEL_NAME: dln_err[torch.float32]["fwd"],
            dln.BWD_KERNEL_NAME: dln_err[torch.float32]["bwd"]}
    errs_bf16 = {attn.KERNEL_NAME: fwd_err[torch.bfloat16],
                 attn.DQ_KERNEL_NAME: bwd_err[torch.bfloat16]["dq"],
                 attn.DKV_KERNEL_NAME: bwd_err[torch.bfloat16]["dkv"],
                 dln.FWD_KERNEL_NAME: dln_err[torch.bfloat16]["fwd"],
                 dln.BWD_KERNEL_NAME: dln_err[torch.bfloat16]["bwd"]}
    summary = []
    for name, (source, replaces) in KERNELS.items():
        row = f32[name]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=train_launches[name],
                     max_abs_err=errs[name], ms=row["ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"],
                     library_ms=row["library_ms"],
                     launches_bf16=bf16_launches[name],
                     max_abs_err_bf16=errs_bf16[name],
                     ms_bf16=bf[name]["ms"],
                     plain_ms_bf16=bf[name]["plain_ms"],
                     bound_ms_bf16=bf[name]["bound_ms"],
                     bound_by_bf16=bf[name]["bound_by"],
                     library_ms_bf16=bf[name]["library_ms"],
                     launches_grad_accum4=accum_launches[name],
                     launches_sequence=seq_launches.get(name, 0),
                     launches_cluster_serving=cs_launches.get(name, 0),
                     launches_int8=int8_launches.get(name, 0),
                     launches_fleet=fleet_launches.get(name, 0),
                     launches_observe=obs_launches.get(name, 0),
                     launches_data=data_launches.get(name, 0),
                     launches_detect=detect_launches.get(name, 0),
                     launches_layers=layers_launches.get(name, 0),
                     launches_parallel=parallel_launches.get(name, 0),
                     launches_interop=interop_launches.get(name, 0),
                     launches_estimators=est_launches.get(name, 0),
                     launches_remat_full=remat_launches.get(name, 0),
                     launches_text=text_launches.get(name, 0),
                     launches_text_heads=text_head_launches.get(name, 0))
        if name == attn.KERNEL_NAME:
            serve_row = kern[torch.float32]
            entry.update(launches_serve=serve_launches[name],
                         ms_serve=serve_row["ms"],
                         bound_ms_serve=serve_row["bound_ms"],
                         library_ms_serve=serve_row["library_ms"],
                         launches_generate=gen_launches,
                         ms_prefill=prefill_k1["ms"],
                         bound_ms_prefill=prefill_k1["bound_ms"],
                         library_ms_prefill=prefill_k1["library_ms"])
        summary.append(entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    _owner = own_run()
    try:
        main()
    finally:
        finish_run(_owner)
