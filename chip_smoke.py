#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--parent TREE]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from paddle_tpu_torch/kernels/csrc/
   (one nvcc per source, all started together) and prints each kernel's
   registers, stack and spills from ``-Xptxas -v`` (a spill in any K5
   instantiation fails the run) and, where the toolkit has
   ``cuobjdump``, the tensor-core (HMMA) instructions and bulk copies
   (UBLKCP) in each kernel's SASS.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card at the main paths' shapes, with the tolerance stated; prints one
   JSON line per phase with the error, the kernel's, the plain version's
   and (where one exists) a single PyTorch call's time, and the bound
   (bytes or operations of this input over the card's peak). K1 (flash
   forward) at the serving shapes. K5 (paged decode) at B8 H12 D64 bs16
   nblk128 with pos spread over 0..2047 (float32, bf16 and int8 pools),
   at B1 pos 32767, B64 with short rows, H6 D128 and H24 D32, block sizes
   32 and 128, and edge rows (pos -1, a last slot on a split boundary and
   one past it; also a bf16 q), each timed warm (one call replayed) and
   cold (a graph walking 12 pool sets, as a decode step walks its
   layers); also at B8 H2 D16 (GPTConfig.tiny()'s head dim); then its
   determinism (two calls, a row alone, a wider table: the same bits).
   With ``--parent`` (another checkout, e.g. a git archive of the parent
   commit) that tree's paged kernel is built and called through that
   tree's own wrapper and timed beside the port's at every K5 phase, in
   the order parent, new, new, parent; and that tree's K2 is called and
   timed beside the port's in the K2 determinism phase. K2 (combined
   backward) at B8 H12 S1024 D64 causal and K3/K4 (dq; dk, dv) at S2048
   causal, on the strided q/k/v views the model makes, plus a non-causal
   + bias and a bf16 case each; K1 and K2 also at the tiling's edges
   (head dim 128 and a ragged S = 1000, float32 and bf16, causal; K1
   non-causal + bias at D = 128), K3 and K4 at head dim 128 and a ragged
   S = 2000 (both types, causal; non-causal + bias at D = 128). K1 and
   K2 at B4 H8 S1024 and K3/K4 at causal S2048 at head dims 80 and 96
   (D128's tile plan), both types. K2 determinism: two calls at the main
   S1024 shape (float32, bf16) give the same dq, dk, dv bits. Bounds
   take float32 at 165 TFLOP/s (3xTF32). One ``bwd_pair`` line per
   (S, type) at S2048 and S4096 causal times K3 then K4 back to back
   beside K2 off its route and SDPA's backward, and holds the pair's
   outputs against K2's. K1 and K2 at bench_bert_long's attention (B16
   H12 S2048 D64, non-causal, a key bias masking each row's padded tail,
   both types), each beside SDPA with the same mask, and a non-causal
   ``bwd_pair`` line there. The S > 1 paged read (``gather_route``, the
   port of the JAX gather composite) at the served verify shape (B8 S5
   H12 D64, 128 blocks of 16, fp32) beside K5, whose counter must not
   move on it.
4. The main paths at GPTConfig.base() widths, seeded random weights, each
   with every kernel launch count zeroed just before it and read just
   after; each path's kernels must have launched:
   - serving: offline greedy generate (dense and paged), teacher-forced
     paged (kernel) vs dense (plain) decode logits, then an
     InferenceServer with 8 decode slots answering 16 requests from 8
     concurrent wire clients, each reply equal to offline greedy generate
     (K1, K5; K5 once per layer of every paged decode step, each step
     a replay of a captured decode graph); then GPTConfig.tiny() (head
     dim 16) through one paged generate;
   - the rest of generation serving, each phase on its own line with the
     card's name and power limit: decode_capture (every decode step of
     PR 1's 8 prompts, dense and paged, a graph replay bitwise its eager
     twin ``CapturedDecode.eager``, greedy and with a sampling row; wall
     ms a step both ways, device ms, idle share, capture s, graph bytes,
     K5 12 launches a paged replay by the counter and in the replay's
     profiler trace: exactly 12, or up to three traces where each
     short one holds fewer kernel records in all than the one that
     shows 12, a trace that lost records); a step that reads the device
     on the host refused with GraphCaptureError, the pool untouched);
     bench_decode (bench.py's: prompts of 128 and 256, 64 new tokens,
     captured decode against generate_naive, teacher-forced logits
     within 1e-3; paged fp32, bf16, int8 rows); spec_decode (spec_k 4,
     n-gram and 1-layer model drafters, dense and paged; verify logits
     within 1e-3 of the sequential steps', K5 not counted on them);
     prefix_prefill (bench.py's _bench_prefix_prefill at prompt 512);
     chunked_prefill (chunks of 128 interleaved with the decode bank
     against monolithic admission, tokens equal); kv_migration (the
     prefill op on one server, generate(kv=) on another, bitwise
     colocated serving in fp32, bf16 and int8); server_full (16
     requests, 8 clients, 8 slots, paged + prefix cache + chunk 128 +
     spec_k 4);
   - training through the Fluid surface (gpt_pretrain + AdamOptimizer +
     Executor, which runs the default pass pipeline: dce, cse,
     fuse_optimizer), dropout 0.1, 5 Adam steps at lr 1e-4 on one seeded
     batch, all 12 layers: fp32 B8 S2048 (K1, K3, K4) and B8 S1024 (K1,
     K2), and bf16 AMP at B8 S2048 (Adam wrapped by
     contrib.mixed_precision.decorate at a static loss scale of 1.0, as
     bench.py's bench_gpt_long trains; K1, K3 and K4 must launch with
     bf16 inputs); finite losses, step 0 within 1.0 of ln(32000), step 4
     below step 0; ms/step, tokens/s, TFLOP/s, peak memory and the
     adam / fused_adam ops a step runs.
   - BERT-base pretraining through the Fluid surface (bert_pretrain +
     AdamOptimizer(noam_decay(768, 10000, 200.0)) wrapped by
     contrib.mixed_precision.decorate at a static loss scale of 1.0),
     bench.py's two BERT trainers, 5 steps each on one seeded batch:
     bert_long (bench_bert_long: B16 S2048, 64 masked positions a row,
     flash attention; K1 and K2 launch once per layer and step, all
     bf16) and the flagship (main(): B64 S128 P20, einsum attention with
     dropout, softmax on the AMP white list; no kernel launches);
     finite losses, step 0 within 1.0 of ln(30522) + ln(2), each step's
     learning rate read back equal to noam_decay's; ms/step, samples/s,
     tokens/s, TFLOP/s against bench.py's _bert_train_flops_per_sample,
     peak memory. Then __graft_entry__.entry()'s evaluation (B8 S128
     through clone(for_test=True)) and one bert_long step with
     FLAGS_verify_passes on (the program verified, every pass
     validated; prints the verification's ms).
5. Gradient check at GPT-base width, 2 layers, S1024 and S2048: every
   param@GRAD of one step through the kernels against the same program
   cloned with the flash_attention op's impl set to "xla" (the plain
   composite), within 1e-3 of its max |grad| (fp32) and 2e-2 (bf16
   AMP). Pipeline A/B at 2 layers, B8 S1024 fp32: one step with
   FLAGS_program_passes "0" and one with "1" from copies of one scope
   leave every param, moment and beta-pow bitwise equal. Dynamic loss
   scaling at 2 layers, 3 steps: finite losses, the loss scale and its
   counters read back. BERT-base width, 2 layers, B8 S2048, flash, bf16
   AMP, dropout 0: every param@GRAD against the composite's within 2e-2,
   and 5 steps at a constant lr 1e-4 whose loss falls.
6. Image classification through the Fluid surface (convolutions in
   cuDNN, GEMMs in cuBLAS: no kernel of the port runs, as the JAX
   package computes them outside Pallas), each path driven with the
   launch counts zeroed and read:
   - resnet50_train: bench.py's bench_resnet50 program, ResNet-50 at
     full depth and width, class_dim 1000, B128 3x224x224,
     Momentum(0.1, 0.9) under bf16 AMP with batch_norm white-listed at a
     static loss scale of 1.0, 5 steps over a two-batch seeded pool on
     the device: finite losses, step 0 within 1.0 of ln(1000); all 53
     conv outputs and 53 batch_norm Y bf16 (declared and on the device);
     every moving mean and variance float32 and moved off (0, 1) in step
     0; fused_momentum in place of the 161 momentum ops; ms/step (median
     of steps 1-4), images/s, TFLOP/s (2 x the conv and fc multiply-adds
     x 3, from the program's shapes) and peak memory;
   - resnet50_eval: clone(for_test=True) of the fp32 program at B128
     over the trained scope, loss and acc finite and repeatable, its
     logits other than a train-mode forward's (it reads the moving
     statistics);
   - cudnn_deterministic_ab: bench_resnet50's step with
     FLAGS_cudnn_deterministic off and on in turns (off, on, on, off,
     twice): device ms (torch.profiler) and wall ms each; one step from
     two copies of one scope under each setting (bitwise or not); two
     eager LeNet runs (B512, 16 steps) under each, bitwise under the
     flag (the port's default);
   - resnet18_tiny_trains: JAX's test_resnet18_tiny_trains (ResNet-18,
     class_dim 4, 32x32, B8, Momentum(0.01, 0.9), 12 steps): last loss
     below 0.7 x the first;
   - resnet_grads: ResNet-18 32x32 B8 fp32, every param@GRAD with the
     bespoke conv2d_grad and batch_norm_grad against the generic vjp over
     the same lowerings, within 1e-3 of its max |grad| (cuDNN's TF32
     setting printed);
   - lenet_train: build_lenet_train() with Adam (lr 0.001) and SGD (lr
     0.01) at B512, 32 Executor.run steps each over synthetic digits:
     steps/s, samples/s, finite and falling losses;
   - fused_optimizers: fused_sgd, fused_momentum (plain and Nesterov)
     and fused_adamw over ResNet-50's 161 parameter shapes, bitwise
     their per-param ops, each timed beside the 161 per-param ops.
7. Saved-model persistence and serving (``io``, ``inference``,
   ``InferenceServer(model_dir)``), each path driven with the launch
   counts zeroed and read:
   - io_roundtrip: ResNet-50 at full width, ``save_persistables`` then
     ``load_persistables`` into a fresh scope (every tensor the same
     bits), ``save_inference_model`` then an ``AnalysisPredictor`` over
     the directory (logits at B8 the eval clone's bits), a bf16 tensor
     through ``save_vars``/``load_vars`` (bitwise), one flipped byte in
     a ``.npy`` (``CheckpointCorruptError`` naming the file); save and
     load ms and bytes;
   - serve_resnet50 (ResNet-50, 1000 classes, 3x224x224, fp32; cuDNN,
     no kernel of the port) and serve_bert_base (BertConfig.base() with
     flash attention, S128, fp32: the encoder at is_test, the [CLS] row
     through pooled_fc and next_sent_fc + softmax; K1 once per layer of
     every executed batch): the program saved with its seeded startup,
     then under bench.py bench_serving's traffic, for request batches
     rb of 1, 8 and 32, a fresh server (max_batch_size 64,
     batch_timeout_ms 2.0, warmed at the buckets of rb and 8 rb)
     answering 8 concurrent wire clients x 8 requests. Every reply
     within 1e-4 of max |ref| of ``AnalysisPredictor.run`` on that
     request alone; at rb 1 a mean batch size above 1 and a cache hit;
     per rb requests/s, samples/s, p50/p99 ms, mean batch size and
     occupancy; per bucket one padded batch's graph replay bit for bit
     an eager run of it, eager ms against replay ms (events) and the
     graph's bytes; peak memory. BERT: K1 12 launches per executed
     batch by the counters, and a profiled replay runs 12 of K1's
     kernel;
   - K1 at the served shape (B32 H12 S128 D64 f32, non-causal, padded
     tail key bias) against its plain version and SDPA;
   - capture_refuses_host_sync: a program whose op calls ``.item()``
     raises ``GraphCaptureError`` naming the op (no eager fallback), and
     the allocator still releases cached memory after it.
8. The training loop (``Executor.run_steps``: K steps as replays of one
   captured CUDA graph; the non-finite guard; ``train_from_dataset``),
   each path driven with the launch counts zeroed and read, each line
   naming the card and its power limit:
   - bert_long_recompute: BERT-base at bench_bert_long's shape (B16
     S2048 P64, flash, bf16 AMP) as ``__graft_entry__`` builds it, noam
     Adam under RecomputeOptimizer with the 12 layer checkpoints: 4
     eager steps and a run_steps slab of 4 from copies of one scope,
     losses, LR and scope bitwise; the program without recompute, one
     slab: its losses, and both slabs' peak memory (recompute must peak
     lower); K1 24 and K2 12 launches a step with recompute, 12 and 12
     without, eager and per replay; wall and device ms a step, idle
     share, tokens/s, TFLOP/s;
   - capture_names_flash_grad: a 1-layer step whose flash grad op is
     made to call ``.item()``: run_steps raises GraphCaptureError naming
     flash_attention_grad and leaves the scope as it was; unpatched, the
     step captures (K2's wrapper makes no host sync);
   - flagship_steps: bench.py main()'s flagship (B64 S128, einsum,
     dropout 0.1), 4 layers deep (``ONE_CARD_LAYERS``): 8 eager steps against a run_steps slab of 8, losses
     and scope bitwise (a replay draws its eager step's dropout masks);
     wall and device ms a step both ways, idle share;
   - train_loop_lenet: bench.py's bench_train_loop (LeNet B512, K 1, 8,
     32, equal step counts): steps/s each, losses bitwise K=1's under
     FLAGS_cudnn_deterministic; whether two eager runs without it agree
     is recorded;
   - nonfinite_steps: the bert_long_recompute program at 2 layers, an
     8-step slab with a NaN in step 3's input_mask: check_nan_inf raises
     NonFiniteError naming fused step 3; skip_nonfinite_steps rolls back
     step 3 only, the scope bitwise a sequential run(skip) over the feeds;
   - train_from_dataset: LeNet over a QueueDataset the phase writes, 3
     slabs of 8 and a tail of 5 batches: steps_per_run 8 ends bitwise
     where steps_per_run 1 ends (FLAGS_cudnn_deterministic on).
9. Wide&Deep CTR (bench.py's bench_widedeep: B4096, dense 13, 26 slots
   over a vocab of 10000, embed 16, MLP 400x3, Adam 1e-3) with
   SelectedRows embedding grads, seeded random weights, each path driven
   with the launch counts zeroed and read (no kernel of the port may
   launch: the JAX package's sparse updates are XLA scatters):
   - widedeep_train: 8 eager steps against a run_steps slab of 8 from
     copies of one scope (losses and scope bitwise, no
     GraphCaptureError), a second slab from a third copy (the tables
     bitwise run to run); falling losses from near ln 2; the 52 table
     updates left per-param by fuse_optimizer; wall and device ms a step
     both ways, idle share, samples/s, peak memory, op counts;
   - widedeep_lazy_adam: the same with Adam(lazy_mode=True): the slab
     captures (no host sync) and is bitwise its eager steps; untouched
     rows keep their params and zero moments; the lazy adam op on one
     table with the batch's duplicate ids against the plain dense Adam
     of the touched rows (float64), within 1e-5 of max |ref|;
   - widedeep_serve: the trained model's predict program saved and
     served by InferenceServer(model_dir) at request batches 1 and 32
     (8 wire clients x 8 requests), replies within 1e-4 of max |ref| of
     AnalysisPredictor.run, each bucket's replay bitwise its eager run.
10. The imperative mode (``fluid.dygraph``), each path driven with the
    launch counts zeroed and read (no kernel of the port may launch: the
    JAX models compute attention as matmul + softmax and einsum); these
    run first among the main paths, after the kernel phases. Every
    ``launches_<path>`` line carries the device memory still allocated
    and reserved after the path (garbage collected, cache emptied):
    - dygraph_transformer: bench.py's bench_dygraph_transformer, the
      dygraph Transformer-base (d_model 512, 8 heads, d_inner 2048, 6+6
      layers, dropout 0.1, vocab 8000, max_len 64), Adam 1e-4, a pool of
      4 seeded batches of B256 src 32 tgt 32 on the device, the bench's
      step (backward, minimize, clear_gradients) under dygraph.jit_step:
      an eager warm-up on 8 rows, 4 eager steps at B256 (wall ms, the
      median of steps 1-3; device ms and kernel launches of one), the
      capture at B256 (seconds, graph pool bytes) and 20 timed replays
      (ms/step, samples/s, target tokens/s, TFLOP/s from the shapes),
      device ms and launches of one replay, idle shares, peaks, the
      first and last loss; every loss finite, and one replay from a
      copied state equal to one eager step from the same state and
      tracer key bitwise (loss, every parameter, every Adam slot, dropout
      on);
    - dygraph_bert_ab: tools/bench_dygraph_ab.py, BertPretrainDy(base)
      4 layers deep (``ONE_CARD_LAYERS``) by jit_step against the static bert_pretrain by run_steps (K 8),
      fp32 B64 S128 P20, Adam 1e-4: ms/step, device ms and launches a
      step each, their ratio, the eager dygraph step's ms;
    - dygraph_capture_refusals: a jit_step step that copies host data to
      the device without to_variable, one that reads a value back and
      one whose to_variable data change each raise GraphCaptureError at
      the capturing call, with no eager pass instead and every
      parameter and Adam slot unchanged.
11. Control flow and the sequence models, after the dygraph phases, each
    path driven with the launch counts zeroed and read (no kernel of the
    port may launch: the JAX package lowers them to XLA loops), each
    line naming the card and its power limit:
    - seq2seq_train: models.seq2seq's GRU encoder-decoder at the
      PaddleNLP seq2seq baseline's IWSLT'15 en-vi widths (vocabularies
      17191 / 7709, embedding and hidden 512, B128, 50 source and 50
      target steps), Adam 1e-3, fp32, one seeded batch on the device: 8
      eager Executor.run steps against a run_steps slab of 8 from a
      copied start (losses, every parameter and Adam slot bitwise; every
      loss finite, falling over the slab); eager and run_steps ms a
      step, device ms, launches per eager step and per replay, idle
      shares, capture seconds, graph pool bytes, peak memory, target
      tokens/s, and the device time of the recurrent ops and of their
      generic-vjp grads (which recompute the recurrence);
    - seq2seq_decode: the beam decode (beam 10, 50 steps) over the
      trained scope on 4 seeded sentences, eagerly and as a
      CapturedProgram replay (bitwise), then saved by
      save_inference_model (pruned through the encoder's recurrent
      sub-block) and run by AnalysisPredictor (the executor's
      sequences); ms a sentence both ways;
    - control_flow: a bounded While with a grad (a run_steps slab
      bitwise its eager steps), an unbounded While (its trip count a
      numpy loop's), an unbounded While and a cond in a training step
      (run_steps raises GraphCaptureError naming the op, the scope
      unchanged), the Switch LR schedule of tests/test_control_flow.py
      (the JAX package's values, SWITCH_LR_SCHEDULE);
    - sequence_lstm: tests/test_book.py's sentiment LSTM (the lstm op
      and sequence_pool "last") and its dynamic_gru encoder-decoder at
      E512 H512 B128 T50 vocab 7709 with seeded lengths: 4 eager steps
      and a run_steps slab of 4, bitwise each other, the losses falling.
12. The optimizer stack and exact training resume, after the phases of
    11, each path driven with the launch counts zeroed and read, each
    line naming the card and its power limit:
    - bert_lamb (the slice's main path): BERT-base at bench_bert_long's
      shape (B16 S2048 P64, flash attention, bf16 AMP, dropout 0.1, no
      recompute) under the LAMB paper's recipe (LambOptimizer(weight
      decay 0.01, beta1 0.9, beta2 0.999, epsilon 1e-6) at
      linear_lr_warmup(polynomial_decay(...)), GradientClipByGlobalNorm
      (1.0)), one seeded batch: 4 eager steps against a run_steps slab of
      4 (losses, LR, every parameter, both moments, both beta-pows, the
      LR counter and the run seed bitwise); train.TrainCheckpoint.save
      after it, synchronous and then in the background while slab 2 runs
      (its files the synchronous save's); a fresh Executor and Scope,
      restore_latest and slab 2 bitwise the uninterrupted run; the loss
      falling; K1 and K2 12 a step (eager and per replay, bf16), no other
      kernel; ms a step by run_steps and eagerly, device ms, idle shares,
      tokens/s, TFLOP/s, kernels per replay, the lamb ops' and the clip
      ops' device ms, the same program under Adam without a clip in the
      same run, checkpoint bytes, save, background gather and restore
      seconds, the peak memory; and (an ``observability_bert_gauges``
      line) the Adam program's live gauges over 3 more slabs, each
      between CUDA events: device_flops_total{where="train"} grows by
      exactly K times the step's estimated cost and K1/K2 by 12 K,
      device_compute_ms_total by the slab's device ms within 10%, the
      train MFU gauge times 989 TFLOP/s over the slab's own TFLOP/s
      (bench.py's formula) in [0.67, 1.5]; one eager step with
      FLAGS_profile_ops 0 and 1 from copies of the scope (after an
      untimed profiled step on a third), bitwise, the measured table
      holding flash_attention and its grad, no row over 5% of its
      total, and memory_profile's static peak beside
      max_memory_allocated;
    - resnet_l2: bench_resnet50's program under Momentum 0.9 at a
      piecewise decay, plain, with L2Decay(1e-4) and as
      LarsMomentumOptimizer(lr, 0.9, lars_coeff 0.001, lars_weight_decay
      5e-5): each a run_steps slab bitwise its eager steps; momentum
      still fused over the regularized grads, LARS per parameter; ms and
      device ms a step each, the regularizer's ops' device ms;
    - optimizer_zoo: every optimizer and wrapper of the slice (and the
      L1, clip-by-value, clip-by-norm and L2 + global-norm variants) on a
      2-layer MLP, an 8-step slab bitwise its eager steps and captured;
      EMA and ModelAverage apply()/restore() between two slabs over the
      scope a captured step holds;
    - dygraph_clip: dygraph_transformer at B256 with all 6+6 layers, its
      Adam with GradientClipByGlobalNorm(1.0) and L2Decay(1e-4), 5 timed
      replays; a replay bitwise CompiledStep.eager from the same state.
13. Data parallelism across cards, first among the main paths, on every
    card of the machine (N = ``torch.cuda.device_count()``), one rank a
    card through the port's launcher (``python -m
    paddle_tpu_torch.distributed.launch``; each rank runs this file with
    ``--dp-worker``, after the parent collected its garbage and emptied
    its cache; the parent's reserved bytes are printed beside each
    launch), each path driven with the launch counts zeroed and read
    (the ranks' launches added), each line naming the card, its power
    limit and N; at N > 1 dp_resnet50 and fleet_bert also run at N = 1
    (a ``*_scaling`` line: images or samples a second at N over N times
    those at 1) and ``nvidia-smi topo -m`` is printed:
    - dp_parity (float32, small width): a conv + batch_norm + fc
      classifier under Momentum through CompiledProgram.with_data_parallel
      and a 2-layer dygraph MLP under Adam with DataParallel and
      jit_step, 3 steps on each rank's rows of a seeded global batch;
      rank 0 also runs each plainly on the global batch on its card:
      every rank's parameters bitwise rank 0's and within 1e-4 of max
      |ref| of the plain run, a run_steps slab bitwise its eager steps;
      then sync batch norm in bf16 at ResNet-50's widths (bench_resnet50's
      program at 224x224, 8 rows a rank, one step through
      with_data_parallel against rank 0's plain batch_norm step on the
      global batch, both from one startup, and rank 0's float32 step):
      the sync_batch_norm op and grad on each rank within 2e-2 of max
      |ref| of float32 autograd at ResNet-50's five batch-norm shapes
      (Y, X@GRAD, Scale@GRAD, Bias@GRAD, running statistics); the step's
      running statistics within 0.1 (relative L2 of the update) of the
      plain step's; the updates of every group (conv and fc weights, BN
      scales, biases, statistics) against plain bf16 and float32
      printed; parameters equal across ranks;
    - dp_resnet50: bench_resnet50's program (B128 224x224 a card, bf16
      AMP with batch_norm white-listed, Momentum(0.1, 0.9)) through
      CompiledProgram(main).with_data_parallel(loss_name), each rank its
      own seeded pool: 4 eager steps against a run_steps slab of 4
      (bitwise), parameters equal across ranks, the loss falling (each
      rank's batch 0 at step 2 below step 0); ms a
      step (the slowest rank) by run_steps and eagerly, images/s a card
      and in total; from the profiled slab of the rank whose profiled
      slab took longest, read together: its wall, busy (the union of
      device intervals over the streams) and idle share (1 - busy /
      wall), and its NCCL kernels' ms and count a step split into
      transfer and waiting (each collective's shortest kernel over the
      ranks is its transfer); at N > 1 every rank's replay trace must
      hold NCCL kernels; the sync_batch_norm ops' and the bucketed
      all-reduce's device ms in an eager step, peak memory, capture
      seconds;
    - fleet_bert: BERT-base at bench_bert_long's shape (B16 S2048 P64,
      flash, bf16 AMP, Adam at noam_decay, dropout 0; 2 layers deep on
      a one-card machine, ``ONE_CARD_LAYERS``) through the Fleet
      collective (fleet.init(PaddleCloudRoleMaker(is_collective=True)),
      distributed_optimizer(opt).minimize(loss), fleet.startup_program,
      run_steps of fleet.main_program, K 4): the slab bitwise its eager
      steps, parameters equal across ranks, K1 and K2 12 launches a step
      on every rank, all bf16, and no other kernel of the port; ms a
      step, samples/s and tokens/s a card and in total, the profiled
      figures as dp_resnet50's, peak memory.
    ``--only-dp`` builds, runs these paths at N = every card only (no
    N = 1 runs, no scaling line) and stops (no kernels line, no ok
    line): the data-parallel figures alone, e.g. on four cards.
    Then tensor parallelism, the same way (``tp_phases``; dp 2 x tp 2
    and tp 4 on four cards, tp 2 on two, tp 1 through the same code on
    one, where each line says that no tensor parallelism was measured
    and tp_bert runs 2 layers), after K1/K2 at 8 rows x 6 heads S2048
    bf16 with a key bias, K1 at 8 x 3 heads S128 float32 causal and K5
    at 8 x 3 heads (pos 128-255) against their plain versions:
    - tp_parity (float32): a narrow BERT (flash) annotated by
      ``bert.apply_tp_sharding``, 3 Adam steps through
      ``with_data_parallel(mesh=make_mesh(dp, tp))`` on each rank's rows
      of a seeded global batch; the gathered parameters within 1e-4 of
      the model's max |ref| of rank 0's plain run on the whole batch,
      the tp-replicated state bitwise equal on every rank and all of it
      across the dp ranks, a run_steps slab bitwise its eager steps, a
      save under tp reloading on one card to the same values;
    - tp_bert: fleet_bert's step (BERT-base, global B16 S2048 P64, flash,
      bf16 AMP, Adam at noam_decay, dropout 0) over the mesh, run_steps
      K 4: the slab bitwise its eager steps, the state checks above,
      step 0's loss within rtol 2e-2 of the plain program's from the
      same startup, K1 and K2 12 launches a step on every rank at 6
      heads, all bf16, no other kernel of the port; ms a step, samples/s
      and tokens/s in total, peak memory a card, the NCCL ms a step of
      the slowest rank's profiled slab split into tp and dp;
    - tp_generate: GPT-base (seeded weights) by ``GPTGenerator(tp=N)``
      beside tp 1 (paged fp32, 8 rows, 128-token prompts, 128 new
      tokens): the tokens equal, the prefill logits within 1e-4 of max
      |ref|, K1 12 a prefill and K5 12 a decode step by replay on each
      rank, NCCL kernels in a profiled replay, the wire bytes of a
      decode step and a prefill under the gate's budget; tokens/s,
      ms a token and decode ms a step at both (each the median of 5
      calls; tp 1 timed on one rank at a time while the others wait,
      with the spread over the ranks), ``speedup_vs_1``, the weight
      bytes a card;
    - tp_serving: GPT-base (seeded weights A, and B saved whole) served
      over the wire by ``InferenceServer(generator=GPTGenerator(tp=N))``
      on every rank (paged fp32, 8 slots; the leader serves, the others
      run the follower loop), 4 client threads: 16 timed requests of
      64-1024 tokens (64 new), two chunked prefills (256-token chunks),
      two n-gram speculative requests (k 4), one cancelled mid-decode,
      one prefill-only request whose KV payload continues on one card in
      a tp 1 ``GenerationEngine``, a profiled window on every rank, a
      hot reload to B with 4 requests in flight, ``drain``, then a
      server with the prefix cache serving one prompt twice: every
      request's tokens equal ``GPTGenerator(tp=1).generate``'s under
      its weights, the pools' digests equal after every group, K1 12 a
      prefill and K5 12 a paged decode step (each capture's warm-up
      included) on every rank, NCCL and K5 kernels in every rank's
      profiled window (tp > 1), 0 blocks held after each drain, every
      follower ending clean; served tokens/s, decode ms a step, the
      leader's hand-off us a step, the weight bytes a card, beside
      tp_generate's rows of the same run.
    ``--only-tp`` runs these alone (no kernels line, no ok line).
13b. Sequence parallelism across cards, right after the tp phases, at
    N = every card (sp 1 through the same code on one card, which says
    that no sequence parallelism was measured): first
    ``sp_kernel_shapes``, K1, K3 and K4 against their plain versions at
    sp_bert's flash shape on four cards (the rank's 2048 queries against
    8192 gathered keys, B2 H12 D64, float32, non-causal, a padded-tail
    key bias) and at H6, each timed by graph replay or events beside
    SDPA's forward or backward with the same mask, not counted; then
    - sp_parity: tp_parity's narrow BERT (4 rows of S128) with
      ``sp_shard=True`` under einsum attention, flash, ring, Ulysses and
      the ring with ``causal=True`` set on the op, 3 Adam steps through
      ``with_data_parallel(mesh=make_mesh(MeshConfig(sp=N)))`` (and tp 2
      x sp 2 on four cards), eagerly and by a run_steps slab from
      copies of one startup scope: the slab bitwise its eager steps,
      the gathered parameters equal on every rank and within 1e-4 of
      max |ref| of rank 0's plain program;
    - sp_bert: BERT-base with ``sp_shard=True`` at S 2048 a card (8192
      on four), B2, max_preds S/32, dropout 0, float32, Adam at 1e-4,
      under ring, Ulysses and flash: 2 eager steps and a run_steps slab
      of 3 (captured, the collectives inside), the captured step freed
      before the next mechanism's; losses within ``SP_LOSS_RTOL`` of rank
      0's one-card run of the same batches (flash, whole sequence); the
      parameters equal on every rank; K1, K3 and K4 12 launches a step
      on every rank under flash (K2 for K3 + K4 at one card's S 2048),
      none under ring and Ulysses; ms a step, tokens/s, peak GB a card
      beside the one-card run's, NCCL kernels and ms a step, idle share
      from a profiled slab.
    ``--only-sp`` runs these alone (no kernels line, no ok line).
13c. Pipeline parallelism across cards, right after the sp phases, at
    N = every card (on one card a 2-stage pipeline on the sequential
    path through the same code, which says that no pipelining was
    measured): first ``pp_kernel_shapes``, K1, K3 and K4 against their
    plain versions at the stage's shape (one microbatch: B1 H12 S2048
    D64, float32, causal), each timed by graph replay or events beside
    SDPA's forward or backward with the same mask, not counted; then
    - pp_parity: a narrow GPT (2 decoder layers a stage, hidden 256, S
      128) in a ``layers.Pipeline``, 3 Adam steps through
      ``with_data_parallel(mesh=make_mesh(MeshConfig(pp=N)))`` (and pp
      2 x dp 2, pp 2 x tp 2 and pp 2 x sp 2 on four cards; beside tp or
      sp every rank of a stage runs it whole, the word embedding split
      on tp or the pipeline's input on the sequence outside it),
      eagerly and by a run_steps slab from
      copies of one startup scope: the slab bitwise its eager steps,
      the gathered parameters equal on every rank and within 1e-4 of
      max |ref| of rank 0's plain program (the sequential path);
    - pp_gpt: GPT-base at B8 S2048, dropout 0, float32, Adam at 1e-4,
      its 12 decoder layers in a ``layers.Pipeline``: pp 4 (3 layers a
      stage, M 8), pp 2 x dp 2 (6 layers a stage, 4 rows a rank, M 4)
      and pp 2 x tp 2 (6 layers a stage run whole by both tp ranks, M
      4, the word embedding and tied head split on tp, the stage slices
      equal on the tp ranks of a stage); 2 eager steps and a run_steps
      slab of 3 (captured, the
      shifts, broadcasts and the dp all-reduce inside) bitwise an
      all-eager twin, the captured step freed before the next grid's;
      the mean of the dp ranks' losses within ``PP_LOSS_RTOL`` of rank
      0's one-card run of the same program and batches (the sequential
      path); the replicated parameters equal on every rank; each rank's
      stage slices equal to theirs in the gathered save; K1 2 x M and
      K3, K4 M a layer and step on every rank (``pp_launches_a_step``);
      ms a step by replay and eagerly, tokens/s in total, peak GB a card
      beside the one-card run's, NCCL kernels and ms a step, each
      rank's busy ms and idle share from a profiled slab.
    ``--only-pp`` runs these alone (no kernels line, no ok line).
13d. Expert parallelism across cards, right after the pp phases, at N =
    every card (on one card ep 1 through the same code, 2 layers deep,
    which says that no expert parallelism was measured): first
    ``moe_kernel_shapes``, K1, K3 and K4 against their plain versions
    at the Switch GPT's attention shapes (B4 and B8 H12 S2048 D64,
    float32, causal), each timed beside SDPA's forward or backward, not
    counted; then
    - moe_parity: a narrow Switch GPT (2 layers, the second's FFN a
      ``switch_moe`` of 4 experts; hidden 256, S 128), 3 Adam steps
      through ``with_data_parallel(mesh=make_mesh(MeshConfig(ep=4)))``
      and ep 2 x dp 2, eagerly and by a run_steps slab: the slab
      bitwise its eager steps, the gathered parameters equal on every
      rank and within 1e-4 of max |ref| of rank 0's plain program;
    - moe_gpt: a Switch GPT-base at B8 S2048 (``MOE_GPT``: decoder
      layers 1, 3, ..., 11 with their FFN a ``switch_moe`` of 8
      experts, width 3072, capacity factor 1.25; the LM loss + 0.01 x
      the mean aux loss), dropout 0, float32, Adam at 1e-4: ep 4 (2
      experts a card) and ep 2 x dp 2 (4 experts a card, 4 rows a dp
      rank); 2 eager steps and a run_steps slab of 3 (captured, the
      all-to-alls, the count all-gathers and the dp all-reduce inside)
      bitwise an all-eager twin, the captured step freed before the
      next grid's; the mean of the dp ranks' losses within
      ``MOE_LOSS_RTOL`` of rank 0's one-card run; the replicated
      parameters equal on every rank; each rank's expert slices equal
      to theirs in the gathered save; K1, K3 and K4 12 a step on every
      rank; ms a step by replay and eagerly, tokens/s in total, peak GB
      a card beside the one-card run's, NCCL kernels and ms a step by
      kind, idle share from a profiled slab, and the share of tokens
      each MoE layer dropped at step 0 (from its gate inputs).
    Both phases also run ep 2 x tp 2 (``gpt.apply_tp_sharding``, the
    experts whole on the tp ranks; K1/K3/K4 at B8 H6 in the kernel
    shapes), and moe_parity ep 2 x sp 2 (every layer
    a MoE layer, non-causal) and pp 2 x ep 2 (the dense layers in a
    2-stage pipeline, one MoE layer after it).
    ``--only-moe`` runs these alone (no kernels line, no ok line). On
    one card the phases of every family (dp, tp, sp, pp, moe, dcn) run
    in one resident worker process (``resident``), not a process each.
    Multi-slice data parallelism, after the moe phases, at N =
    every card (two slices of two on four cards; at N = 1 dcn_dp 1
    through the same code, the line saying that no multi-slice was
    measured): first ``dcn_kernel_shapes``, K1 and K2 against their
    plain versions at dcn_bert's attention (B4 H12 S2048 D64 bf16,
    non-causal, key bias), beside SDPA, not counted; then
    - dcn_bert: fleet_bert's step (BERT-base, flash, bf16 AMP, Adam at
      noam_decay, dropout 0) over a global B16 S2048 P64 split over
      dcn_dp x dp dcn-major, through
      ``with_data_parallel(mesh=make_mesh(MeshConfig(dcn_dp=2,
      dp=2)))`` with the decomposed grad sync, the same compiled
      program with the flat one (``FLAGS_dcn_hierarchical`` off) and
      dp 4 (at ``ONE_CARD_LAYERS`` on one card), each from one start:
      K eager steps against a run_steps slab of 4 (bitwise), the
      parameters equal on every rank, the rank-mean losses of the runs
      within ``DCN_LOSS_RTOL``, the gate (``parallel.dcn``) passing the
      decomposed run and flagging only the flat all-reduce in the flat
      one, K1 and K2 12 a step on every rank, all bf16; ms a step and
      tokens/s, NCCL kernels and ms a step by kind, idle share, peak
      GB a card, the gate's bytes by group and the bytes across slices
      of flat over decomposed; the four cards share one NVLink domain;
    - slice_drill: a narrow BERT (2 layers, hidden 256, S128) under
      ``train.SliceSupervisor`` over two slices (two virtual slices in
      a world of 1 on one card), checkpoints every slab: slice 1's
      beats dropped through ``train.slice_heartbeat``, the run shrinks
      to dcn_dp 1 on slice 0 at the same global batch and regrows; the
      events JAX's (slice_lost, then slice_rejoined), every slab trained
      once, and slice 0's state at the regrow bitwise a never-failed
      narrow run's from the shrink's checkpoint; recovery seconds split
      into drain, checkpoint, rebuild, restore and capture.
    ``--only-dcn`` runs these alone (no kernels line, no ok line).
14. The core layer surface, last among the main paths:
    - gpt_programs: GPT's generation programs built from the registered
      decode ops (``models.gpt.gpt_prefill``, ``gpt_decode_step``,
      ``gpt_decode_step_paged`` with fp32, bf16 and int8 pools,
      ``gpt_verify_step_paged``) at GPTConfig.base() over the params of
      the port's ``GPT`` module, run by the ``Executor`` for 8 rows, a
      128-token prompt and 16 teacher-forced decode steps: logits (and
      caches) within 1e-4 of max |ref| of the module's ``prefill``,
      ``decode_step``, ``decode_step_paged`` and ``verify_step_paged``
      (bf16 and int8 pools too, which both sides quantize alike); K1 12
      launches a prefill run, K5 12 a paged decode step and 0 in the
      verify program (its S > 1 reads take the gather route); a greedy loop over the prefill and
      paged decode programs token for token the port's
      ``GPTGenerator.generate``; ms a decode step through the program
      eagerly beside the module's eager and replayed step, and the ms
      of the clones the program's write ops make a paged step and a
      prefill run;
    - book_vgg16: the Fluid book's vgg16_bn_drop (chapter 3, five
      ``nets.img_conv_group`` blocks with BN and dropout, fc 512 + BN +
      dropout twice, fc 10 softmax into cross_entropy) on CIFAR-10's
      3x32x32 at the book's batch of 128, Adam(1e-3), float32, seeded
      images and labels: 4 eager steps against a run_steps slab of 4
      from copies of one scope (losses and scope bitwise, dropout on),
      the next slab's mean loss below the first's; ms a step both ways,
      images/s, device ms a step,
      idle share, kernels a replay, peak memory and capture seconds; no
      kernel of the port (cuDNN convs);
    - book_models: the seven tests/test_book.py programs the core
      layers make buildable (fit_a_line, word2vec skip-gram and n-gram,
      the two-tower recommender, recognize_digits_conv, the small VGG,
      glu + SDPA),
      built as those tests build them over seeded data, 3 steps on the
      card and on the CPU from one startup: losses within 1e-4 of max
      |ref|; ms a step on the card.
15. The observability core, last: GPT-base generation served over the
    wire (paged fp32 pool, 8 slots, max_len 2048, the serving path's 8
    prompts twice from 8 clients, 32 new tokens each) at
    FLAGS_trace_sample_rate 1, then 16 times over (256 requests a pass)
    at rates 0, 1, 1, 0, 0, 1 (the median and range of tokens/s and
    decode ms a step at each: the telemetry's cost), then at rate 1
    under profiler.profiler(state="All", trace_dir=...):
    every request's trace holds client/send, serving/handle, queue,
    prefill, decode and reply under one trace id, each child inside its
    parent; the ``metrics`` op parses as Prometheus text, its token
    counter grew by the tokens received, the decode flop counter grew,
    the decode MFU and HBM ratios (from the counters, unclamped) and
    gauges lie in (0, 1.05], the SLO rule states are exported; ``debug_dump`` returns events; the kvpool gauges were
    non-zero in flight; the device trace holds one K5 and one K1 record
    per launch the counters saw (a trace that lost records is taken
    again, up to 3 in all); tools/timeline.py renders the span JSON.
16. Training and serving resilience, last among the main paths, each
    path driven with the launch counts zeroed and read, each line naming
    the card and its power limit:
    - resilience_serving (K1, K5): GPT-base generation served over the
      wire (paged fp32 pool, 8 slots, max_len 2048, the LoopSupervisor
      on) with two seeded parameter sets A and B (B written by
      ``io.save_params``, manifest included): a hot reload of B over
      the wire while 8 greedy requests (prompts 64-1024, 128 new
      tokens) decode on A, 8 more sent while the swap is pending (the
      rows in flight give ``generate``'s tokens under A, the queued and
      later ones its tokens under B; K5 12 launches per decode step over
      the window), a corrupt copy of B refused with
      ``CheckpointCorruptError`` over the wire, one generate sent with
      one request id on two connections (run once), a 1024-token
      request cancelled by id (``RequestCancelledError``, its blocks
      back), a chaos fault in a decode step with 8 rows in flight (the
      rows fail typed, the loop restarts once, no block leaks), a
      decode step stalled past a 3 s watchdog (``WatchdogTimeout``, an
      ``InternalServerError`` over the wire; the bank rebuilt), a drain
      with 8 rows in flight (new generates refused typed, ping and
      health answering, ``{"drained": true, "remaining": 0}``), each
      batch after a fault B's tokens; tokens/s before and after the
      reload, the swap pause, the reload's wall time, the ms of the
      in-place weight copy, the health snapshot;
    - supervised_bert (K1, K2): BERT-base at bench_bert_long's shape, 2
      layers deep (``ONE_CARD_LAYERS``; B16 S2048 P64, flash, bf16 AMP,
      Adam at noam_decay, dropout 0.1)
      under ``train.TrainingSupervisor``, K 2 over 6 prestacked seeded
      slabs, four runs on one executor: clean (health every 3 slabs),
      crash and hang (a dispatch fault at slab 3, a stall past a 5 s
      step watchdog at slab 5, checkpoints every 2 slabs), preempted at
      slab 2 (``PreemptedError`` naming the fast checkpoint), resumed;
      runs 2 and 4 end bitwise run 1's (every scope tensor, every
      reported loss), run 2 restarts after FaultInjected then
      WatchdogTimeout, the captured entries do not grow after run 1, K1
      and K2 12 a step (bf16) and no other kernel, the health gauges
      finite, each run's goodput ledger spanning the measured run
      within 1% and attributing no more than it; ms a slab, each save's
      and restore's seconds, the preemption save against
      ``preempt_deadline_s``, recovery ms, peak memory.
17. Prints the {"kernels": [...]} line (K1-K5), then as the last line
    {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result line.
"""
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
# float32: 495 TF32 / 3, the least time a product held to float32 accuracy
# can take on this card (3xTF32: three TF32 products per float32 product)
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}

FA_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu"
PA_SOURCE = "paddle_tpu_torch/kernels/csrc/paged_attention.cu"
FA_REPLACES = "paddle_tpu/kernels/flash_attention.py:298"
PA_REPLACES = "paddle_tpu/kernels/paged_attention.py:219"
BWD_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu"
# wrapper name -> (TPU kernel's pallas_call site, outputs, score-sized
# products the function needs: s, dp and dq; s, dp, dk and dv; all five)
BWD_KERNELS = {
    "flash_attention_bwd_single": ("paddle_tpu/kernels/flash_attention.py:482",
                                   ("dq", "dk", "dv"), 5),
    "flash_attention_bwd_dq": ("paddle_tpu/kernels/flash_attention.py:514",
                               ("dq",), 3),
    "flash_attention_bwd_dkv": ("paddle_tpu/kernels/flash_attention.py:542",
                                ("dk", "dv"), 4),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters):
    """Device time of one call of ``fn``: captured once into a CUDA graph
    and replayed ``iters`` times between two events (the host's launch
    overhead stays out of the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_name(mangled):
    """``flash_bwd_k2_kernel<float,128,80>`` from a mangled template
    kernel name: its last ``<length><name>I<args>E`` component."""
    import re
    best = mangled
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        start, n = m.end(), int(m.group(1))
        name = mangled[start:start + n]
        if name.endswith("kernel") and mangled[start + n:start + n + 1] == "I":
            best = f"{name}<{_template_args(mangled[start + n + 1:])}>"
    return best


def _template_args(s):
    """``float,int8,64`` from a mangled argument list (``faLi64E...``),
    read up to the ``E`` that closes it: f float, a int8,
    13__nv_bfloat16 bf16, S<n>_ a repeat of the last named type (bf16 is
    the only one), Li<n>E an int."""
    import re
    out, named = [], "?"
    for tok in re.findall(r"13__nv_bfloat16|Li\d+E|S\d*_|.", s):
        if tok == "E":
            break
        if tok.startswith("Li"):
            out.append(tok[2:-1])
        elif tok.startswith("S"):
            out.append(named)
        else:
            out.append({"f": "float", "a": "int8",
                        "13__nv_bfloat16": "bf16"}.get(tok, tok))
            named = out[-1] if tok.startswith("13") else named
    return ",".join(out)


def sass_report(nvcc, lib_path):
    """Tensor-core instructions (HMMA opcodes) and bulk copies (UBLKCP,
    ``cp.async.bulk``) in each kernel of a built library, counted in
    ``cuobjdump -sass`` from ``nvcc``'s toolkit; None where the toolkit
    has no cuobjdump."""
    import re
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    rows, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = {"entry": _kernel_name(m.group(1)), "hmma": {},
                   "bulk_copy": {}}
            rows.append(cur)
            continue
        m = re.search(r"\b(HMMA\.[\w.]+|UBLKCP[\w.]*)", line)
        if m and cur is not None:
            key = "hmma" if m.group(1).startswith("HMMA") else "bulk_copy"
            cur[key][m.group(1)] = cur[key].get(m.group(1), 0) + 1
    return {"phase": "sass", "library": os.path.basename(lib_path),
            "kernels": rows}


def ptxas_report(name, out):
    """Registers, spills and stack of each kernel entry from the
    ``-Xptxas -v`` build output of library ``name``."""
    import re
    rows, cur = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": _kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return {"phase": "ptxas", "library": name, "kernels": rows}


# ------------------------------------------------------------ kernel phases

def attention_inputs(torch, B, H, S, D, dtype, with_bias, seed, packed):
    """Seeded q, k, v, bias (or None) and a generator on the card.
    ``packed``: q/k/v are the strided views the model hands the kernels
    (one ``[B, S, 3*H*D]`` qkv projection, split, viewed as ``[B, S, H,
    D]`` and transposed to ``[B, H, S, D]``, as ``models/gpt.py`` and
    ``models/bert.py`` do); else contiguous tensors. ``with_bias`` True
    masks a random quarter of the keys; "padded" masks each row's padded
    tail (a row keeps its first S/2..S keys), as BERT's ``input_mask``
    becomes ``(mask - 1) * 10000``."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        h = H * D
        qkv = torch.randn(B, S, 3 * h, device="cuda", generator=g).to(dt)
        q, k, v = (t.view(B, S, H, D).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
    else:
        q, k, v = (torch.randn(B, H, S, D, device="cuda",
                               generator=g).to(dt) for _ in range(3))
    bias = None
    if with_bias == "padded":
        lens = torch.randint(S // 2, S + 1, (B, 1, 1, 1), device="cuda",
                             generator=g)
        keep = torch.arange(S, device="cuda") < lens
        bias = torch.where(keep, 0.0, -1e4).float()
    elif with_bias:
        keep = torch.rand(B, 1, 1, S, device="cuda", generator=g) > 0.25
        bias = torch.where(keep, 0.0, -1e4).float()
    return q, k, v, bias, g


def flash_phase(torch, fa, B, H, S, D, dtype, causal, with_bias, seed,
                packed):
    F = torch.nn.functional
    q, k, v, bias, _ = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, packed)
    out, lse = fa.flash_attention_fwd(q, k, v, bias=bias, causal=causal)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, bias=bias,
                                          causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    ok = err <= tol and lse_err <= 1e-3 and bool(torch.isfinite(out).all())
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, bias=bias, causal=causal), 20)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(
        q, k, v, bias=bias, causal=causal), 5)
    mask = None if bias is None else bias.to(q.dtype)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal), 20)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4.0 * B * H * pairs * D
    elem = q.element_size()
    nbytes = 4 * B * H * S * D * elem + B * H * S * 4 \
        + (B * S * 4 if with_bias else 0)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    rec = {"phase": "flash_attention_fwd", "B": B, "H": H, "S": S, "D": D,
           "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views" if packed else "contiguous",
           "max_abs_err": err, "lse2_max_abs_err": lse_err, "atol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": ops / ms / 1e9, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain "
                             f"version: {rec}")
    return rec


def paged_inputs(torch, pa, B, H, D, bs, nblk, pos, kv_dtype, seed, sets,
                 q_dtype="float32"):
    """Seeded q [B,H,1,D], block tables [B,nblk] (a random permutation of
    the pool's blocks, trash block 0 past each row's allocation), pos [B]
    and ``sets`` distinct k/v pool sets of one layout (as a decoder's
    layers hold them); returns a list of ``(q, k, v, tables, pos, k_scale,
    v_scale)`` per set and the live slots."""
    import numpy as np
    pos = np.asarray(pos, np.int32)
    nb = [min(int(p) // bs + 1, nblk) if p >= 0 else 0 for p in pos]
    N = sum(nb) + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    used = 0
    for b, n in enumerate(nb):
        tables[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, 1, D, device="cuda", generator=g).to(
        getattr(torch, q_dtype))
    t = torch.from_numpy(tables).cuda()
    p = torch.from_numpy(pos).cuda()
    out = []
    for _ in range(sets):
        kf = torch.randn(N, H, bs, D, device="cuda", generator=g)
        vf = torch.randn(N, H, bs, D, device="cuda", generator=g)
        if kv_dtype == "int8":
            (kp, ks), (vp, vs) = pa.quantize_kv(kf), pa.quantize_kv(vf)
        else:
            dt = getattr(torch, kv_dtype)
            kp, vp, ks, vs = kf.to(dt), vf.to(dt), None, None
        out.append((q, kp, vp, t, p, ks, vs))
    return out, live_slots(pos, bs, nblk)


def live_slots(pos, bs, nblk):
    """Key slots the rows can see: sum of pos + 1, within the table."""
    import numpy as np
    return int(np.clip(np.asarray(pos, np.int64) + 1, 0, nblk * bs).sum())


def parent_paged(tree):
    """The paged decode wrapper of another checkout ``tree`` (e.g. a git
    archive of the parent commit), imported from there as the module
    ``parent_kernels.paged_attention``: it builds that tree's kernel into
    that tree's build directory and is called as ``paged_attention``.
    Only the kernel modules are loaded, not the tree's package (whose
    custom ops would clash with the port's)."""
    import importlib
    import types
    pkg = types.ModuleType("parent_kernels")
    pkg.__path__ = [os.path.join(tree, "paddle_tpu_torch", "kernels")]
    sys.modules[pkg.__name__] = pkg
    return importlib.import_module("parent_kernels.paged_attention")


def parent_flash():
    """The flash-attention wrappers of the tree :func:`parent_paged`
    loaded: that tree's module registers the same torch custom op as the
    port's, so the registration is skipped while it is imported (only
    its kernel wrappers are called, never its autograd path)."""
    import importlib
    import torch
    real = torch.library.custom_op
    torch.library.custom_op = lambda *a, **k: (lambda fn: fn)
    try:
        return importlib.import_module("parent_kernels.flash_attention")
    finally:
        torch.library.custom_op = real


# pool sets a cold timing walks, as GPT-base's decoder walks its layers
# (more where their live bytes would not exceed twice the L2)
COLD_SETS = 12
L2_BYTES = 50e6


def cold_sets(live, H, D, kv_dtype):
    elem = {"float32": 4, "bfloat16": 2, "int8": 1}[kv_dtype]
    return max(COLD_SETS, int(2 * L2_BYTES // (2 * live * H * D * elem)) + 1)


def paged_phase(torch, pa, name, B, H, D, bs, nblk, pos, kv_dtype, seed,
                parent=None, q_dtype="float32"):
    """K5 against its plain version on one input, timed warm (one call
    replayed in a CUDA graph) and cold (a graph that walks ``cold_sets``
    distinct pool sets, more than 2x the L2's live bytes, as a decode step
    walks its layers). Rows with nothing visible (pos < 0) must be 0, as
    the TPU kernel gives them (the gather composite averages there).
    Limit: max |kernel - ref| <= 1e-4 and <= 1e-4 of max |ref| (both read
    the same stored values in float32); a bfloat16 q gives a bfloat16
    output, held to 1e-2 of max |ref| (its rounding). ``parent``: another
    tree's paged module (:func:`parent_paged`), checked and timed beside
    the port's kernel in the order parent, new, new, parent where its
    wrapper takes the input."""
    nsets = cold_sets(live_slots(pos, bs, nblk), H, D, kv_dtype)
    sets, live = paged_inputs(torch, pa, B, H, D, bs, nblk, pos, kv_dtype,
                              seed, nsets, q_dtype)
    q, kp, vp, t, p, ks, vs = sets[0]
    kern = pa.paged_attention

    def run(fn, s=sets[0]):
        return fn(*s[:5], s[5], s[6])

    out = run(kern)
    ref = pa.paged_attention_ref(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    dead = (p < 0)[:, None, None, None]
    ref = torch.where(dead, torch.zeros_like(ref), ref).float()
    err = (out.float() - ref).abs().max().item()
    max_ref = ref.abs().max().item()
    tol = 1e-2 * max_ref if q_dtype == "bfloat16" \
        else 1e-4 * min(1.0, max_ref)
    ok = err <= tol and bool(torch.isfinite(out).all()) \
        and bool((out.float() * dead == 0).all())
    perr = refused = None
    if parent is not None:
        try:
            perr = (run(parent.paged_attention).float() - ref).abs().max() \
                .item()
            ok = ok and perr <= tol
        except ValueError as e:          # its wrapper refuses this input
            refused = str(e)
    parent_ok = perr is not None
    nbytes = 2 * live * H * D * kp.element_size() \
        + (2 * live * H * 4 if ks is not None else 0) \
        + 2 * B * H * D * q.element_size() + B * nblk * 4 + B * 4
    cold_live = nsets * 2 * live * H * D * kp.element_size()

    def warm(fn):
        return time_ms(torch, lambda: run(fn), 50)

    def cold(fn):
        def walk():
            for s in sets:
                run(fn, s)
        return time_ms(torch, walk, 10) / len(sets)

    rec = {"phase": "paged_attention", "case": name, "B": B, "H": H, "D": D,
           "block_size": bs, "nblk": nblk, "q_dtype": q_dtype,
           "kv_dtype": kv_dtype, "live_slots": live,
           "splits": pa.split_plan(bs, nblk), "cold_sets": nsets}
    if B <= 8:
        rec["pos"] = [int(x) for x in pos]
    if parent_ok:
        old = parent.paged_attention
        w = [warm(old), warm(kern), warm(kern), warm(old)]
        c = [cold(old), cold(kern), cold(kern), cold(old)]
        rec.update(ms=(w[1] + w[2]) / 2, cold_ms=(c[1] + c[2]) / 2,
                   parent_ms=(w[0] + w[3]) / 2,
                   parent_cold_ms=(c[0] + c[3]) / 2, warm_pccp=w,
                   cold_pccp=c, parent_max_abs_err=perr)
    else:
        rec.update(ms=warm(kern), cold_ms=cold(kern),
                   parent_ms=None, parent_cold_ms=None)
        if refused:
            rec["parent_refused"] = refused
    bound_ms, bound_by = bound(nbytes, 4.0 * live * H * D, "float32")
    rec.update(max_abs_err=err, max_abs_ref=max_ref, limit=tol,
               plain_ms=time_ms(torch, lambda: pa.paged_attention_ref(
                   q, kp, vp, t, p, k_scale=ks, v_scale=vs), 10),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               cold_live_bytes_over_l2=cold_live / L2_BYTES,
               gbytes_per_s=nbytes / rec["ms"] / 1e6,
               cold_gbytes_per_s=nbytes / rec["cold_ms"] / 1e6, ok=ok)
    emit(rec)
    if not ok:
        raise AssertionError(f"paged_attention disagrees with its plain "
                             f"version: {rec}")
    return rec


def paged_determinism(torch, pa, kv_dtype, seed):
    """Two calls give the same bits, and each row of the main shape
    decoded alone (B = 1), and with its table padded 37 entries wider,
    gives the bits it gets in the batch: a split's boundaries depend on
    the block index alone."""
    import numpy as np
    pos = np.linspace(0, 2047, 8).round().astype(np.int32)
    (s,), _ = paged_inputs(torch, pa, 8, 12, 64, 16, 128, pos, kv_dtype,
                           seed, 1)
    q, kp, vp, t, p, ks, vs = s
    a = pa.paged_attention(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    b = pa.paged_attention(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    repeat = bool(torch.equal(a, b))
    alone = wide = True
    for r in range(len(pos)):
        sl = slice(r, r + 1)
        one = pa.paged_attention(q[sl], kp, vp, t[sl], p[sl], k_scale=ks,
                                 v_scale=vs)
        tw = torch.cat([t[sl], torch.zeros(1, 37, dtype=t.dtype,
                                           device=t.device)], 1)
        padded = pa.paged_attention(q[sl], kp, vp, tw, p[sl], k_scale=ks,
                                    v_scale=vs)
        alone = alone and bool(torch.equal(one, a[sl]))
        wide = wide and bool(torch.equal(padded, a[sl]))
    rec = {"phase": "paged_determinism", "kv_dtype": kv_dtype,
           "repeat_bitwise": repeat, "row_alone_bitwise": alone,
           "wider_table_bitwise": wide, "ok": repeat and alone and wide}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"paged_attention is not deterministic: {rec}")
    return rec


def paged_phases(torch, pa, parent):
    """Every K5 phase; returns the main shape's float32 record (the
    kernels line). Main shape: B8 H12 D64 bs16 nblk128, pos spread over
    0..2047 (the decode shape of chip_smoke's serving rows at full
    context)."""
    import numpy as np
    main_pos = np.linspace(0, 2047, 8).round().astype(np.int32)
    main = None
    for kv in ("float32", "bfloat16", "int8"):
        rec = paged_phase(torch, pa, "main", 8, 12, 64, 16, 128, main_pos,
                          kv, 3, parent)
        main = main or rec
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "B1_pos32767", 1, 12, 64, 16, 2048, [32767],
                    kv, 4, parent)
        torch.cuda.empty_cache()
    short = np.random.default_rng(5).integers(0, 512, 64).astype(np.int32)
    paged_phase(torch, pa, "B64_short", 64, 12, 64, 16, 128, short,
                "float32", 5, parent)
    for H, D in ((6, 128), (24, 32)):
        for kv in ("float32", "int8"):
            paged_phase(torch, pa, f"H{H}_D{D}", 8, H, D, 16, 128, main_pos,
                        kv, 6, parent)
    # GPTConfig.tiny()'s head dim (its serving path decodes through here)
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "H2_D16", 8, 2, 16, 16, 128, main_pos, kv,
                    12, parent)
    for bs in (32, 128):
        for kv in ("float32", "int8"):
            paged_phase(torch, pa, f"bs{bs}", 8, 12, 64, bs, 2048 // bs,
                        main_pos, kv, 7, parent)
    # a row with nothing visible; rows whose last live slot ends a split,
    # and one slot past it
    span = pa.split_plan(16, 128)[0] * 16
    edge = [-1, 0, span - 1, span, 2 * span - 1, 2 * span, 2047, 1000]
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "edges", 8, 12, 64, 16, 128, edge, kv, 8,
                    parent)
    paged_phase(torch, pa, "edges", 8, 12, 64, 16, 128, edge, "bfloat16",
                9, parent, q_dtype="bfloat16")
    # a block size that is no multiple of 4 (an int8 block's scales are
    # then no whole 16-byte vector)
    span = pa.split_plan(6, 341)[0] * 6
    edge6 = [-1, 0, span - 1, span, 2 * span - 1, 2 * span, 2045, 1000]
    for kv in ("float32", "int8"):
        paged_phase(torch, pa, "edges_bs6", 8, 12, 64, 6, 341, edge6, kv, 11,
                    parent)
    for kv in ("float32", "bfloat16", "int8"):
        paged_determinism(torch, pa, kv, 10)
    torch.cuda.empty_cache()
    return main


# ------------------------------------------------------------- end to end

def end_to_end(torch, np, cfg, device=None, max_len=2048, lo=64, hi=1024,
               new=32):
    """The main path at ``cfg``; prompts of ``lo``..``hi`` tokens and
    ``new`` new tokens each. Returns the number of paged decode steps
    taken."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import (Client, InferenceServer,
                                          KVBlockPool, ServingStats)
    t0 = time.perf_counter()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    print(f"model: GPT {cfg.num_layers} layers h{cfg.hidden_size} "
          f"vocab {cfg.vocab_size}, params on {gen.device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(0)
    lens = np.linspace(lo, hi, 8).round().astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    res = {}

    for paged in (False, True):
        gen.stats = None
        gen.generate(prompts[:1], max_new_tokens=2, paged=paged)   # warm
        gen.stats = stats = ServingStats()
        t0 = time.perf_counter()
        outs = gen.generate(prompts, max_new_tokens=new, paged=paged)
        wall = time.perf_counter() - t0
        gen.stats = None
        for o in outs:
            if o.shape != (new,) or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"bad generate output {o}")
        key = "paged" if paged else "dense"
        res[key] = outs
        emit({"phase": f"generate_{key}", "rows": len(prompts),
              "prompt_lens": lens.tolist(), "new_tokens": new,
              "wall_s": wall, "prefill_ms": stats.hist["prefill"]
              .snapshot()["mean_ms"],
              "decode_ms_per_step": stats.hist["decode"]
              .snapshot()["mean_ms"],
              "tokens_per_s": len(prompts) * new / wall})
    agree = float(np.mean([(a == b).mean()
                           for a, b in zip(res["dense"], res["paged"])]))
    print(f"greedy agreement dense vs paged: {agree:.4f}", flush=True)

    # teacher forcing: the same prefill into both caches, then the dense
    # greedy tokens fed to both decode steps
    tokens, pos_ids, last = gen._pack_prompts(prompts)
    bb, s = tokens.shape
    logits, ks, vs = gen.run_prefill(tokens, pos_ids, last)
    cache_k, cache_v = gen.new_dense_caches(bb)
    for c, x in zip(cache_k + cache_v, ks + vs):
        c[:, :, :s] = x
    pool = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads, d_head=cfg.d_head,
                       max_seq_len=gen.max_len, dtype="fp32",
                       device=gen.device)
    for r, n in enumerate(lens):
        pool.alloc(r, int(n))
    pool.scatter_prefill(list(range(bb)), ks, vs, s)
    del ks, vs
    pos = lens.astype(np.int32).copy()
    feed = np.stack(res["dense"], 1)                    # [new, rows]
    worst = 0.0
    for step in range(new - 1):
        tok = feed[step]
        for r in range(bb):
            pool.ensure(r, int(pos[r]))
        dense = gen.run_decode(tok, pos, cache_k, cache_v)
        paged = gen.run_decode_paged(tok, pos, pool)
        if not (torch.isfinite(dense).all() and torch.isfinite(paged).all()):
            raise AssertionError("non-finite decode logits")
        worst = max(worst, (dense - paged).abs().max().item())
        pos += 1
    emit({"phase": "teacher_forced_decode", "steps": new - 1,
          "max_abs_logit_diff_paged_vs_dense": worst, "atol": 1e-3})
    if worst > 1e-3:
        raise AssertionError(f"paged decode logits differ from dense by "
                             f"{worst}")
    del cache_k, cache_v, pool

    # the server: 16 requests from 8 concurrent clients through 8 slots
    lens2 = rng.integers(lo, hi + 1, 8)
    prompts16 = prompts + [rng.integers(1, cfg.vocab_size, n).astype(
        np.int32) for n in lens2]
    want = gen.generate(prompts16[:8], max_new_tokens=new, paged=True) \
        + gen.generate(prompts16[8:], max_new_tokens=new, paged=True)
    server = InferenceServer(generator=gen, decode_slots=8,
                             paged=True).start()
    got, errors = {}, []

    def client(idxs):
        try:
            with Client(server.endpoint, timeout=600) as c:
                for i in idxs:
                    got[i] = c.generate(prompts16[i], new)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=((i, i + 8),))
                   for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"server clients failed: {errors}")
        st = server.stats()
    finally:
        server.stop()
    mismatched = [i for i in range(16)
                  if not np.array_equal(got.get(i), want[i])]
    emit({"phase": "server", "requests": 16, "clients": 8, "slots": 8,
          "wall_s": wall, "tokens_per_s": 16 * new / wall,
          "requests_completed": st["requests_completed"],
          "kvpool_blocks_in_use": st["kvpool_blocks_in_use"],
          "decode_steps": st["decode_steps"],
          "token_p50_ms": st["token_p50_ms"],
          "mismatched_vs_offline": mismatched})
    if mismatched or st["requests_completed"] != 16 \
            or st["kvpool_blocks_in_use"] != 0:
        raise AssertionError(f"server replies differ from offline greedy "
                             f"generate for requests {mismatched}")
    # every paged decode step (a capture's warm-up, a replay) launches
    # K5 once per layer: the generator's and the server engine's
    return {"paged_decode_steps": gen.decoder.steps["paged"]
            + server.gen_engine.decoder.steps["paged"]}


def event_ms(torch, fn, iters):
    """Device time of one call of ``fn`` between two events over
    ``iters`` back-to-back calls, after one warm-up call (for calls of a
    millisecond or more, where the host's launch overhead is hidden)."""
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


def bwd_phase(torch, fa, name, B, H, S, D, dtype, causal, with_bias, seed,
              packed):
    """One backward kernel (``name``: its wrapper) against
    ``flash_attention_bwd_ref`` on the same inputs; the forward's out and
    lse2 come from K1. Limit: max |kernel - ref| per output within 1e-4
    (float32) or 2e-2 (bf16) of that output's max |ref|. The library time
    is the backward of ``scaled_dot_product_attention`` alone (autograd
    through one retained forward)."""
    F = torch.nn.functional
    replaces, outs, products = BWD_KERNELS[name]
    q, k, v, bias, g = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, packed)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, causal)
    dout = torch.randn(B, H, S, D, device="cuda", generator=g).to(q.dtype)
    args = (q, k, v, bias, scale, causal, out, lse, dout)
    kern = getattr(fa, name)
    got = kern(*args)
    got = (got,) if len(outs) == 1 else got
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(*args)))
    torch.cuda.synchronize()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    errs, rel = {}, {}
    for o, t in zip(outs, got):
        r = ref[o].float()
        errs[o] = (t.float() - r).abs().max().item()
        rel[o] = errs[o] / r.abs().max().item()
    ok = max(rel.values()) <= tol and all(bool(torch.isfinite(t).all())
                                          for t in got)
    del got, ref
    ms = event_ms(torch, lambda: kern(*args), 10)
    plain_ms = event_ms(torch, lambda: fa.flash_attention_bwd_ref(*args), 3)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), dout, retain_graph=True), 10)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 2.0 * products * B * H * pairs * D
    nbytes = (4 + len(outs)) * B * H * S * D * q.element_size() \
        + 2 * B * H * S * 4 + (B * S * 4 if with_bias else 0)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    rec = {"phase": name, "replaces": replaces, "B": B, "H": H, "S": S,
           "D": D, "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views" if packed else "contiguous",
           "max_abs_err": max(errs.values()), "abs_err": errs,
           "err_over_max_ref": rel, "limit_over_max_ref": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": ops / ms / 1e9, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def bwd_pair_phase(torch, fa, B, H, S, D, dtype, seed, causal=True,
                   with_bias=False):
    """The K3 + K4 route against its yardsticks on one input (the model's
    strided views; causal, or non-causal with a key bias): K3 then K4
    back to back as one timed call, K2 on the same input, and the
    backward of ``scaled_dot_product_attention`` with the same mask (the
    one library call that computes dq, dk and dv). The pair's outputs are
    held against K2's (two independent kernels; limit as in
    ``bwd_phase``), so no S x S plain backward is materialized."""
    F = torch.nn.functional
    q, k, v, bias, g = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, True)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, causal)
    dout = torch.randn(B, H, S, D, device="cuda", generator=g).to(q.dtype)
    args = (q, k, v, bias, scale, causal, out, lse, dout)

    def pair():
        return (fa.flash_attention_bwd_dq(*args),
                *fa.flash_attention_bwd_dkv(*args))

    got, want = pair(), fa.flash_attention_bwd_single(*args)
    torch.cuda.synchronize()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    rel = {o: ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
           for o, a, b in zip(("dq", "dk", "dv"), got, want)}
    ok = max(rel.values()) <= tol and all(bool(torch.isfinite(t).all())
                                          for t in got)
    del got, want
    k3_ms = event_ms(torch, lambda: fa.flash_attention_bwd_dq(*args), 10)
    k4_ms = event_ms(torch, lambda: fa.flash_attention_bwd_dkv(*args), 10)
    ms = event_ms(torch, pair, 10)
    k2_ms = event_ms(torch, lambda: fa.flash_attention_bwd_single(*args), 10)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), dout, retain_graph=True), 10)
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 7 * B * H * S * D * q.element_size() + 2 * B * H * S * 4 \
        + (B * S * 4 if bias is not None else 0)
    # the pair does 7 score-sized products (K3: 3, K4: 4), K2 5
    bound_ms, bound_by = bound(nbytes, 14.0 * B * H * pairs * D, dtype)
    k2_bound_ms = bound(nbytes, 10.0 * B * H * pairs * D, dtype)[0]
    rec = {"phase": "bwd_pair", "B": B, "H": H, "S": S, "D": D,
           "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views",
           "err_over_max_k2": rel, "limit_over_max_ref": tol,
           "k3_ms": k3_ms, "k4_ms": k4_ms, "ms": ms, "k2_ms": k2_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "k2_bound_ms": k2_bound_ms, "bound_by": bound_by,
           "single_pass_route": fa.single_pass_backward(S, causal),
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"K3 + K4 disagree with K2: {rec}")
    return rec


def k2_determinism(torch, fa, dtype, parent_fa=None, seed=1031):
    """K2 called twice on the main S1024 input (B8 H12 D64 causal, the
    model's strided views) gives the same dq, dk and dv bits: its k
    tiles add their dq shares in a fixed order. With ``parent_fa``
    (another tree's wrappers, :func:`parent_flash`) that tree's K2 is
    called twice too (recorded, not held) and both are timed in the
    order parent, new, new, parent."""
    q, k, v, _, g = attention_inputs(torch, 8, 12, 1024, 64, dtype, False,
                                     seed, True)
    scale = 64 ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, scale, True)
    dout = torch.randn(8, 12, 1024, 64, device="cuda", generator=g).to(
        q.dtype)
    args = (q, k, v, None, scale, True, out, lse, dout)

    def same_bits(kern):
        a, b = kern(*args), kern(*args)
        return {o: bool(torch.equal(x, y))
                for o, x, y in zip(("dq", "dk", "dv"), a, b)}

    rec = {"phase": "k2_determinism", "B": 8, "H": 12, "S": 1024, "D": 64,
           "dtype": dtype, "causal": True,
           "bitwise": same_bits(fa.flash_attention_bwd_single)}
    new = fa.flash_attention_bwd_single
    if parent_fa is not None:
        old = parent_fa.flash_attention_bwd_single
        rec["parent_bitwise"] = same_bits(old)
        t = [event_ms(torch, lambda f=f: f(*args), 10)
             for f in (old, new, new, old)]
        rec.update(ms=(t[1] + t[2]) / 2, parent_ms=(t[0] + t[3]) / 2,
                   pccp_ms=t)
    else:
        rec["ms"] = event_ms(torch, lambda: new(*args), 10)
    rec["ok"] = all(rec["bitwise"].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"K2 is not deterministic: {rec}")
    return rec


# ----------------------------------------------------- training (Fluid)

def gpt_train_flops_per_sample(cfg, seq_len):
    """Analytic matmul FLOPs per sample of one training step: forward x3
    for forward + backward, causal attention counting the live half of
    the score square (the formula of the repository's bench.py
    ``_gpt_train_flops_per_sample``)."""
    h, L, ffn, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                    cfg.vocab_size)
    per_layer = (4 * 2 * seq_len * h * h + 2 * 2 * seq_len * h * ffn
                 + 2 * seq_len * seq_len * h)
    return 3 * (L * per_layer + 2 * seq_len * h * V)


def build_train(cfg, B, S, amp=None):
    """``gpt_pretrain`` + ``AdamOptimizer(1e-4).minimize``; ``amp``
    "static" wraps Adam in bf16 mixed precision at a static loss scale of
    1.0 (bench.py's ``bench_gpt_long``), "dynamic" with dynamic loss
    scaling (``decorate``'s defaults). Returns (main, startup, loss,
    params_grads, optimizer)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(cfg, B, S)
        opt = fluid.optimizer.AdamOptimizer(1e-4)
        if amp is not None:
            kw = {"static": dict(init_loss_scaling=1.0,
                                 use_dynamic_loss_scaling=False),
                  "dynamic": {}}[amp]
            opt = fluid.contrib.mixed_precision.decorate(opt, **kw)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out["loss"], params_grads, opt


UPDATE_OPS = ("sgd", "momentum", "adam", "adamw")


def optimizer_ops(exe, program, fetch_names):
    """{op type: count} of the optimizer update ops (per-param and
    fused) in the program the executor runs for ``program`` (the pass
    pipeline's output)."""
    ops = exe._optimize(program, fetch_names).global_block().ops
    types = UPDATE_OPS + tuple("fused_" + t for t in UPDATE_OPS)
    counts = {t: sum(op.type == t for op in ops) for t in types}
    return {t: n for t, n in counts.items() if n}


def train_phase(torch, np, cfg, B, S, steps, place=None, seed=0, amp=None):
    """``steps`` Adam steps of ``gpt_pretrain`` through the Fluid surface
    on one seeded batch; ``place`` None is the GPU (a CPUPlace rehearses
    the path at a tiny size); ``amp`` as in :func:`build_train`. Returns
    the phase record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, _ = build_train(cfg, B, S, amp)
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = gpt_train_flops_per_sample(cfg, S) * B
    name = f"train_gpt_B{B}_S{S}" + ("" if amp is None else f"_amp_bf16")
    rec = {"phase": name, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "dropout": cfg.dropout, "amp": amp, "steps": steps,
           "program_passes": fluid.get_flags("FLAGS_program_passes")[
               "FLAGS_program_passes"],
           "optimizer_ops_per_step": optimizer_ops(exe, main, [loss.name]),
           "losses": losses, "step_ms": wall,
           "median_step_ms_after_first": step_ms,
           "tokens_per_s": B * S / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "achieved_tflops": flops / step_ms / 1e9,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
           "ln_vocab": float(np.log(cfg.vocab_size))}
    bad = [x for x in losses if not np.isfinite(x)]
    if bad or abs(losses[0] - np.log(cfg.vocab_size)) > 1.0 \
            or not losses[-1] < losses[0]:
        emit(rec)
        raise AssertionError(f"GPT training losses are off: {losses}")
    return rec


def copied_scope(torch, fluid, scope):
    new = fluid.Scope()
    for n, v in scope.items():
        new.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return new


def grad_check(torch, np, cfg, B, S, place=None, seed=1, amp=None):
    """Every param@GRAD of one ``gpt_pretrain`` step through the kernels
    against the plain composite (:func:`grads_vs_composite`); limit 1e-3
    of each grad's max |value|, 2e-2 under bf16 AMP (``amp``
    "static")."""
    from paddle_tpu_torch.models import gpt
    main, startup, _, params_grads, _ = build_train(cfg, B, S, amp)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    name = f"grad_check_B{B}_S{S}" + ("" if amp is None else "_amp_bf16")
    return grads_vs_composite(torch, np, name, cfg, main, startup,
                              params_grads, feed, place,
                              1e-3 if amp is None else 2e-2)


def grads_vs_composite(torch, np, name, cfg, main, startup, params_grads,
                       feed, place, limit):
    """Every param@GRAD of one step of ``main`` through the kernels
    against the same program cloned with the flash_attention op's impl
    set to "xla" (the plain composite), from copies of one startup scope
    (so dropout draws the same masks); each within ``limit`` of its max
    |value|."""
    import paddle_tpu_torch as fluid
    plain = main.clone()
    for op in plain.global_block().ops:
        if op.type == "flash_attention":
            op.attrs["impl"] = "xla"
        elif op.type == "flash_attention_grad":
            op.attrs["__fwd_op__"]["attrs"]["impl"] = "xla"
    exe = fluid.Executor(place)
    s1 = fluid.Scope()
    exe.run(startup, scope=s1)
    s2 = copied_scope(torch, fluid, s1)
    names = [g.name for _, g in params_grads]
    kern = exe.run(main, feed=feed, fetch_list=names, scope=s1)
    ref = exe.run(plain, feed=feed, fetch_list=names, scope=s2)
    worst, worst_name = 0.0, None
    for n, a, b in zip(names, kern, ref):
        a, b = a.astype(np.float32), b.astype(np.float32)
        r = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
            if np.isfinite(a).all() else float("inf")
        if r >= worst:
            worst, worst_name = r, n
    rec = {"phase": name, "layers": cfg.num_layers, "grads": len(names),
           "worst_err_over_max_grad": worst, "worst_grad": worst_name,
           "limit": limit}
    emit(rec)
    if not worst <= limit:
        raise AssertionError(f"kernel grads differ from the plain "
                             f"composite's: {rec}")
    return rec


def pipeline_ab(torch, np, cfg, B, S, place=None, seed=2):
    """One step with FLAGS_program_passes "0" and one with "1" (dce, cse,
    fuse_optimizer) from copies of one startup scope: every param,
    moment and beta-pow bitwise equal (fused_adam is the per-param adam
    update), the loss too. Prints the pipeline's ``stats()``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, _ = build_train(cfg, B, S)
    exe = fluid.Executor(place)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    s1 = copied_scope(torch, fluid, s0)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    old = fluid.get_flags("FLAGS_program_passes")
    try:
        fluid.set_flags({"FLAGS_program_passes": "0"})
        l0, = exe.run(main, feed=feed, fetch_list=[loss], scope=s0)
        fluid.set_flags({"FLAGS_program_passes": "1"})
        l1, = exe.run(main, feed=feed, fetch_list=[loss], scope=s1)
        stats = passes.stats()
        ops = optimizer_ops(exe, main, [loss.name])
    finally:
        fluid.set_flags(old)
    names = [n for n, v in s0.items() if isinstance(v, torch.Tensor)]
    differ = [n for n in names
              if not torch.equal(s0.find_var(n), s1.find_var(n))]
    rec = {"phase": f"pipeline_ab_B{B}_S{S}", "layers": cfg.num_layers,
           "state_tensors": len(names), "differ": differ,
           "loss_bitwise": bool(np.array_equal(l0, l1)),
           "optimizer_ops_with_pipeline": ops,
           "pass_stats": [{k: r[k] for k in ("pass", "ops_before",
                                              "ops_after", "detail")}
                          for r in stats["passes"]],
           "pass_total_ms": stats["total_ms"]}
    rec["ok"] = not differ and rec["loss_bitwise"] and ops["fused_adam"] > 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the pass pipeline changed the step: {rec}")
    return rec


def dynamic_scaling(torch, np, cfg, B, S, steps, place=None, seed=3):
    """``steps`` bf16 AMP steps with dynamic loss scaling (initial scale
    2^15, scale doubles after 1000 clean steps): finite, falling losses;
    no overflow, so the scale stays 2^15, the good counter counts the
    steps and the bad one stays 0."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, opt = build_train(cfg, B, S, "dynamic")
    state = [opt.get_loss_scaling(), opt._num_good_steps,
             opt._num_bad_steps]
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    losses = []
    for _ in range(steps):
        lv, scale, good, bad = exe.run(main, feed=feed,
                                       fetch_list=[loss] + state,
                                       scope=scope)
        losses.append(float(np.ravel(lv)[0]))
    rec = {"phase": f"dynamic_loss_scaling_B{B}_S{S}",
           "layers": cfg.num_layers, "losses": losses,
           "loss_scaling": float(scale[0]), "num_good_steps": float(good[0]),
           "num_bad_steps": float(bad[0])}
    rec["ok"] = (all(np.isfinite(losses)) and losses[-1] < losses[0]
                 and rec["loss_scaling"] == 2.0 ** 15
                 and rec["num_good_steps"] == steps
                 and rec["num_bad_steps"] == 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dynamic loss scaling is off: {rec}")
    return rec


def tiny_generate(torch, np, device=None):
    """GPTConfig.tiny() (head dim 16) through one paged and one dense
    greedy generate: tokens in range, the same length. K5 runs at D16."""
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    cfg = GPTConfig.tiny()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=64,
                       device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 30)]
    paged = gen.generate(prompts, max_new_tokens=12, paged=True)
    dense = gen.generate(prompts, max_new_tokens=12, paged=False)
    ok = all(o.shape == (12,) and o.min() >= 0 and o.max() < cfg.vocab_size
             for o in paged + dense)
    agree = float(np.mean([(a == b).mean() for a, b in zip(paged, dense)]))
    rec = {"phase": "generate_tiny_paged", "d_head": cfg.d_head,
           "rows": len(prompts), "new_tokens": 12,
           "greedy_agreement_dense_vs_paged": agree, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"tiny paged generate is off: {rec}")
    return rec


# ------------------------------------------- generation serving (GPT)

def card_line(rec):
    """``rec`` with the card's name and power limit, printed."""
    rec["card"] = CARD["card"]
    emit(rec)
    return rec


def pr1_prompts(np, cfg, lo=64, hi=1024, n=8, seed=0):
    """PR 1's serving prompts: ``n`` seeded prompts of ``lo``..``hi``
    tokens."""
    rng = np.random.default_rng(seed)
    lens = np.linspace(lo, hi, n).round().astype(int)
    return [rng.integers(1, cfg.vocab_size, k).astype(np.int32)
            for k in lens]


def prefilled(torch, np, gen, prompts, paged, kv_dtype="fp32", room=64):
    """A fresh storage holding ``prompts``' prefill: ``(kv, first greedy
    tokens, positions)`` (a dense bank, or a pool with ``room`` tokens of
    blocks past each prompt)."""
    from paddle_tpu_torch.serving import KVBlockPool
    tokens, pos_ids, last = gen._pack_prompts(prompts)
    bb, s = tokens.shape
    logits, ks, vs = gen.run_prefill(tokens, pos_ids, last)
    if paged:
        cfg = gen.cfg
        kv = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                         num_heads=cfg.num_heads, d_head=cfg.d_head,
                         max_seq_len=gen.max_len, dtype=kv_dtype,
                         prefix_cache=False, device=gen.device)
        for r, p in enumerate(prompts):
            kv.alloc(r, min(p.size + room, gen.max_len))
        kv.scatter_prefill(list(range(len(prompts))), ks, vs, s)
    else:
        kv = gen.new_dense_caches(bb)
        for c, new in zip(kv[0] + kv[1], ks + vs):
            c[:, :, :s] = new
    pos = np.zeros(bb, np.int32)
    pos[:len(prompts)] = [p.size for p in prompts]
    return kv, torch.argmax(logits, -1).cpu().numpy().astype(np.int32), pos


def _kv_tensors(kv):
    return kv.tensors() if hasattr(kv, "tensors") else kv[0] + kv[1]


def decode_capture(torch, np, cfg, device=None, max_len=2048, new=32,
                   mixed_steps=8, lo=64, hi=1024):
    """The decode step as a replayed graph against its eager twin
    (``CapturedDecode.eager``) at PR 1's 8 prompts, dense and paged fp32:
    tokens and logits bitwise at every one of ``new`` greedy steps and
    ``mixed_steps`` steps with row 0 sampling (temperature 0.8, top-k 40)
    from a reseeded generator; wall ms a step (replay and eager), device
    ms and idle share of a replay, capture seconds, graph bytes, K5
    launches per replay (12 paged, 0 dense). Then a decoder whose step
    reads the device on the host: GraphCaptureError, the pool bitwise as
    it was and no graph kept."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.framework.cuda_graph import (CapturedDecode,
                                                       GraphCaptureError)
    from paddle_tpu_torch.models import GPTGenerator, init_params
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    cuda = torch.device(device or "cuda").type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    prompts = pr1_prompts(np, cfg, lo, hi)
    out = {"phase": "decode_capture", "rows": len(prompts),
           "new_tokens": new}
    for kind in ("dense", "paged"):
        kv, tok, pos = prefilled(torch, np, gen, prompts, kind == "paged",
                                 room=new + mixed_steps + 4)
        rows = tok.shape[0]
        dec = gen.new_decoder()
        greedy = np.zeros(rows, np.float32)
        topk = np.zeros(rows, np.int32)
        worst = 0.0
        for step in range(new + mixed_steps):
            temp, tk = greedy, topk
            if step >= new:            # row 0 samples, the rest greedy
                temp = greedy.copy()
                temp[0] = 0.8
                tk = topk.copy()
                tk[0] = 40
            dec.generator.manual_seed(1000 + step)
            a = dec.eager(tok, pos, temp, tk, kv)
            la = dec.logits.clone()
            dec.generator.manual_seed(1000 + step)
            b = dec.run(tok, pos, temp, tk, kv)
            worst = max(worst, (la - dec.logits).abs().max().item())
            if not np.array_equal(a, b):
                raise AssertionError(f"{kind} step {step}: the replay drew "
                                     f"{b}, its eager twin {a}")
            tok, pos = b, pos + 1
        if worst != 0.0:
            raise AssertionError(f"{kind}: replayed logits differ from "
                                 f"eager by {worst}")
        walls = {}
        for name, fn in (("replay", dec.run), ("eager", dec.eager)):
            sync()
            t0 = time.perf_counter()
            for _ in range(8):
                tok = fn(tok, pos, greedy, topk, kv)
            walls[name] = (time.perf_counter() - t0) * 1e3 / 8
        rec = {"wall_ms_per_step": walls["replay"],
               "eager_wall_ms_per_step": walls["eager"],
               "captures": dec.captures, "capture_s": dec.capture_s,
               "graph_bytes": dec.graph_bytes}
        if cuda:
            before = pa.paged_attention.launches
            for _ in range(4):
                dec.run(tok, pos, greedy, topk, kv)
            rec["k5_launches_per_replay"] = \
                (pa.paged_attention.launches - before) / 4
            # the counter is raised from the capture's recorded wrapper
            # calls; the trace of a replay counts K5's kernel on the card
            want = cfg.num_layers if kind == "paged" else 0
            if rec["k5_launches_per_replay"] != want:
                raise AssertionError(
                    f"{kind}: K5 counted {rec['k5_launches_per_replay']} "
                    f"a replay, not {want}")
            ms, names, seen = traced_count(
                torch, lambda: dec.run(tok, pos, greedy, topk, kv),
                "paged_split_kernel", want)
            rec.update(device_ms_per_step=ms,
                       kernels_per_step=sum(names.values()),
                       k5_kernels_in_replay_trace=seen[-1][0],
                       k5_and_kernels_per_trace=seen,
                       idle_share=1 - ms / walls["replay"])
        out[kind] = rec
        del kv
    # a step that reads the device on the host cannot be captured: the
    # capture raises and leaves the pool as it was (but the trash block
    # 0, which the warm-up writes and nothing reads)
    class HostRead:
        def __init__(self, model):
            self.model = model

        def decode_step_paged(self, *args):
            logits = self.model.decode_step_paged(*args)
            float(logits[0, 0])
            return logits
    pool, tok, pos = prefilled(torch, np, gen, prompts[:2], True, room=8)
    before = [t[1:].clone() for t in pool.tensors()]
    bad = CapturedDecode(HostRead(gen.model), gen.device,
                         counters=kernels.COUNTED)
    refused = None
    if cuda:
        try:
            bad.run(tok, pos, np.zeros(2, np.float32), np.zeros(2, np.int32),
                    pool)
        except GraphCaptureError as e:
            refused = str(e)[:160]
        untouched = all(torch.equal(a, b[1:])
                        for a, b in zip(before, pool.tensors()))
        if refused is None or not untouched or len(bad.cache):
            raise AssertionError(f"a host read in the decode step: refused "
                                 f"{refused!r}, pool untouched {untouched}, "
                                 f"graphs kept {len(bad.cache)}")
    out["host_read_refused"] = refused
    return card_line(out)


def teacher_forced_naive(torch, np, gen, prompt, feed):
    """Max |logit| difference between the cached path (the prefill, then
    a decode step per fed token) and the full recompute (``run_logits``
    over the prompt and the tokens fed so far) at each position."""
    tokens, pos_ids, last = gen._pack_prompts([prompt])
    s = tokens.shape[1]
    logits, ks, vs = gen.run_prefill(tokens, pos_ids, last)
    bank = gen.new_dense_caches(tokens.shape[0])
    for c, new in zip(bank[0] + bank[1], ks + vs):
        c[:, :, :s] = new
    del ks, vs
    worst = 0.0
    pos = np.array([prompt.size], np.int32)
    for t in range(len(feed) + 1):
        ctx = np.concatenate([prompt, feed[:t]]).astype(np.int32)
        naive = gen.run_logits(*gen._pack_prompts([ctx]))
        worst = max(worst, (naive[:1] - logits[:1]).abs().max().item())
        if t < len(feed):
            logits = gen.run_decode(np.array([feed[t]], np.int32), pos,
                                    bank[0], bank[1])
            pos += 1
    return worst


def bench_decode_phase(torch, np, cfg, device=None, seqs=(128, 256),
                       new=64, reps=2):
    """bench.py's bench_decode on the port: a prompt of each of ``seqs``
    tokens, ``new`` greedy tokens by the captured KV-cached decode
    against ``generate_naive`` (the full recompute, K1 per layer per
    token): tokens/s, ms/token, speedup, token equality; the
    teacher-forced logits of the two within 1e-3 at every position (hard
    check); then the paged pool in fp32, bf16 and int8 at the longest
    prompt: tokens/s and token agreement with the dense bank."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    gen = GPTGenerator(cfg, init_params(cfg, seed=0),
                       max_len=max(seqs) + new + 1, device=device)
    rng = np.random.default_rng(0)
    rec = {"phase": "bench_decode", "new_tokens": new, "seqs": {}}
    worst = 0.0
    for seq in seqs:
        prompt = [rng.integers(1, cfg.vocab_size, seq).astype(np.int32)]
        kv_out = gen.generate(prompt, max_new_tokens=new)     # warm
        naive_out = gen.generate_naive(prompt, max_new_tokens=new)
        times = {}
        for name, fn in (("kv", gen.generate), ("naive", gen.generate_naive)):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(prompt, max_new_tokens=new)
            times[name] = (time.perf_counter() - t0) / reps
        err = teacher_forced_naive(torch, np, gen, prompt[0],
                                   kv_out[0][:new - 1])
        worst = max(worst, err)
        rec["seqs"][str(seq)] = {
            "tokens_per_s": new / times["kv"],
            "ms_per_token": times["kv"] / new * 1e3,
            "naive_tokens_per_s": new / times["naive"],
            "naive_ms_per_token": times["naive"] / new * 1e3,
            "speedup_vs_naive": times["naive"] / times["kv"],
            "token_equality": float(np.mean(kv_out[0] == naive_out[0])),
            "teacher_forced_max_abs": err}
    dense = kv_out
    rec["paged"] = {}
    for kv_dtype in ("fp32", "bf16", "int8"):
        out = gen.generate(prompt, max_new_tokens=new, paged=True,
                           kv_dtype=kv_dtype)
        t0 = time.perf_counter()
        for _ in range(reps):
            gen.generate(prompt, max_new_tokens=new, paged=True,
                         kv_dtype=kv_dtype)
        dt = (time.perf_counter() - t0) / reps
        rec["paged"][kv_dtype] = {
            "tokens_per_s": new / dt, "ms_per_token": dt / new * 1e3,
            "agreement_with_dense": float(np.mean(out[0] == dense[0]))}
    rec["teacher_forced_max_abs"] = worst
    rec["atol"] = 1e-3
    gen.release()
    card_line(rec)
    if worst > 1e-3:
        raise AssertionError(f"cached decode logits differ from the full "
                             f"recompute by {worst}")
    return rec


def verify_vs_sequential(torch, np, gen, prompts, span, paged):
    """Max |logit| difference between one verify pass over ``span``
    (``[rows, K+1]`` tokens from each row's position) and K+1 sequential
    decode steps feeding the same tokens, from twin storages. Also
    whether K5's counter stayed put across the verify pass."""
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    kv_v, _, pos = prefilled(torch, np, gen, prompts, paged, room=16)
    kv_s, _, _ = prefilled(torch, np, gen, prompts, paged, room=16)
    S = span.shape[1]
    span_pos = pos[:, None] + np.arange(S, dtype=np.int32)[None, :]
    before = pa.paged_attention.launches
    if paged:
        logits = gen.run_verify_paged(span, span_pos, pos,
                                      np.full(len(pos), S, np.int32), kv_v)
    else:
        logits = gen.run_verify(span, pos, span_pos, kv_v[0], kv_v[1])
    k5_still = pa.paged_attention.launches == before
    worst = 0.0
    for i in range(S):
        step = gen.run_decode_paged(span[:, i], pos + i, kv_s) if paged \
            else gen.run_decode(span[:, i], pos + i, kv_s[0], kv_s[1])
        worst = max(worst, (step - logits[:, i]).abs().max().item())
    return worst, k5_still


def gather_route(torch, np, pa, B=8, H=12, D=64, bs=16, nblk=128, S=5):
    """The S > 1 paged read (``paged_attention_gather``, the port of the
    JAX gather composite) at the served verify shape: B rows of S = K+1
    queries over ``nblk`` blocks of ``bs`` (fp32), positions spread to
    the table's end, timed by graph replay beside K5 on one query a row
    over the same pool; its bound counts each row's live keys and values
    once; K5's counter must not move across the gather calls. A kernel
    phase: it runs outside every driven path."""
    pos = np.linspace(0, nblk * bs - S, B).round().astype(np.int32)
    (q1, kp, vp, t, p, _, _), = paged_inputs(torch, pa, B, H, D, bs, nblk,
                                             pos, "float32", seed=5, sets=1)[0]
    q = torch.randn(B, H, S, D, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    before = pa.paged_attention.launches
    gather_ms = time_ms(torch, lambda: pa.paged_attention_gather(
        q, kp, vp, t, p), 20)
    k5_still = pa.paged_attention.launches == before
    live = int((pos.astype(np.int64) + S).sum())
    nbytes = 2 * live * H * D * 4 + 2 * q.numel() * 4
    bound_ms, by = bound(nbytes, 4 * H * S * live * D, "float32")
    k5_ms = time_ms(torch, lambda: pa.paged_attention(q1, kp, vp, t, p), 20)
    rec = card_line({
        "phase": "gather_route",
        "shape": f"B{B} S{S} H{H} D{D} bs{bs} nblk{nblk} fp32",
        "gather_ms": gather_ms, "bound_ms": bound_ms, "bound_by": by,
        "gathered_mb_per_pool": B * nblk * bs * H * D * 4 / 1e6,
        "k5_one_query_ms": k5_ms, "k5_still": k5_still})
    if not k5_still:
        raise AssertionError(f"gather_route: K5 counted S > 1 reads {rec}")
    return rec


def spec_decode(torch, np, cfg, device=None, max_len=2048, new=32,
                spec_k=4, lo=64, hi=1024):
    """Speculative decoding at PR 1's 8 prompts, ``spec_k`` drafts a
    step, with the n-gram and the 1-layer model drafter, on the dense
    bank and the paged pool: acceptance rate, tokens/s, verify ms a step
    and token agreement with non-speculative greedy; blocks in use back
    to 0. Hard checks: the verify pass's logits at each
    span position within 1e-3 of the sequential decode step's (dense and
    paged), and K5's counter still across the S > 1 reads."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import ServingStats
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    prompts = pr1_prompts(np, cfg, lo, hi)
    rec = {"phase": "spec_decode", "rows": len(prompts), "new_tokens": new,
           "spec_k": spec_k}
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        ref = gen.generate(prompts, max_new_tokens=new, paged=paged)
        t0 = time.perf_counter()
        gen.generate(prompts, max_new_tokens=new, paged=paged)
        base = time.perf_counter() - t0
        rec[f"{kind}_nonspec_tokens_per_s"] = len(prompts) * new / base
        for mode in ("ngram", "model"):
            gen.generate(prompts[:1], max_new_tokens=4, paged=paged,
                         spec_k=spec_k, spec_mode=mode)       # warm
            gen.stats = stats = ServingStats()
            t0 = time.perf_counter()
            out = gen.generate(prompts, max_new_tokens=new, paged=paged,
                               spec_k=spec_k, spec_mode=mode)
            wall = time.perf_counter() - t0
            gen.stats = None
            snap = stats.snapshot()
            rec[f"{kind}_{mode}"] = {
                "acceptance": snap["spec_accept_ratio"],
                "spec_steps": snap["spec_steps"],
                "tokens_per_s": len(prompts) * new / wall,
                "verify_ms_per_step": snap["decode_mean_ms"],
                "agreement_with_nonspec": float(np.mean(
                    [np.mean(a == b) for a, b in zip(out, ref)]))}
        if paged:
            pool = next(iter(gen._paged_pools.values()))
            rec["paged_blocks_in_use_after"] = pool.blocks_in_use()
    span = np.stack([r[:spec_k + 1] for r in ref]).astype(np.int32)
    checks = {}
    for paged in (False, True):
        checks["paged" if paged else "dense"] = verify_vs_sequential(
            torch, np, gen, prompts, span, paged)
    rec["verify_vs_sequential_max_abs"] = {k: v[0] for k, v in
                                           checks.items()}
    rec["k5_still_on_verify"] = checks["paged"][1]
    rec["atol"] = 1e-3
    gen.release()
    card_line(rec)
    worst = max(v[0] for v in checks.values())
    if worst > 1e-3 or not rec["k5_still_on_verify"] \
            or rec["paged_blocks_in_use_after"]:
        raise AssertionError(f"spec_decode: verify logits off by {worst}, "
                             f"K5 still {rec['k5_still_on_verify']}, "
                             f"blocks left {rec['paged_blocks_in_use_after']}")
    return rec


def prefix_prefill(torch, np, cfg, device=None, prompt_len=512):
    """bench.py's _bench_prefix_prefill: the same prompt admitted twice
    through the chunked path of a prefix-caching engine (2 slots,
    bucket_min 8); the repeat adopts the cached blocks and replays one
    token. Cold and warm ms, warm_over_cold, reused tokens, prefix
    entries, evictable blocks after release, leaked blocks (must be 0),
    and the warm first-token logits within 1e-3 of the cold ones; K5's
    counter still across the S > 1 chunk reads."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import GenerationEngine, GenerationRequest
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    gen = GPTGenerator(cfg, init_params(cfg, seed=0),
                       max_len=prompt_len + 32, bucket_min=8, device=device)
    rng = np.random.default_rng(0)
    warm_prompt = rng.integers(1, cfg.vocab_size, prompt_len).astype(np.int32)
    prompt = rng.integers(1, cfg.vocab_size, prompt_len).astype(np.int32)
    engine = GenerationEngine(gen, slots=2, paged=True, prefix_cache=True)

    def prefill_once(slot, p):
        t0 = time.perf_counter()
        st = engine.start_prefill(GenerationRequest(p, max_new_tokens=4),
                                  slot)
        while not engine.prefill_chunk(st):
            pass
        engine.finish_prefill(st)
        return (time.perf_counter() - t0) * 1e3, st

    prefill_once(0, warm_prompt)
    prefill_once(0, warm_prompt)
    engine.release_slot(0)
    k5 = pa.paged_attention.launches
    cold_ms, cold = prefill_once(0, prompt)
    warm_ms, warm = prefill_once(1, prompt)
    err = (warm["first_logits"] - cold["first_logits"]).abs().max().item()
    stats = engine.pool.stats()
    engine.release_slot(0)
    engine.release_slot(1)
    rec = card_line({
        "phase": "prefix_prefill", "prompt_tokens": prompt_len,
        "cold_ms": cold_ms, "warm_ms": warm_ms,
        "warm_over_cold": warm_ms / cold_ms,
        "reused_tokens": int(warm["reused"]),
        "prefix_entries": stats["prefix_entries"],
        "evictable_blocks_after_release": engine.pool.cached_blocks(),
        "leaked_blocks": engine.pool.blocks_in_use(),
        "warm_vs_cold_first_logits_max_abs": err, "atol": 1e-3,
        "k5_still_on_chunks": pa.paged_attention.launches == k5})
    if err > 1e-3 or rec["leaked_blocks"] or rec["reused_tokens"] \
            != prompt_len or not rec["k5_still_on_chunks"]:
        raise AssertionError(f"prefix_prefill: {rec}")
    return rec


def run_requests(np, engine, prompts, new, spec_k=0):
    """Prompts through a DecodeBatcher over ``engine``: token lists."""
    from paddle_tpu_torch.serving import (DecodeBatcher, GenerationRequest,
                                          RequestQueue)
    b = DecodeBatcher(RequestQueue(max_depth=64), engine,
                      spec_k=spec_k).start()
    try:
        reqs = [GenerationRequest(p, max_new_tokens=new) for p in prompts]
        for r in reqs:
            b.queue.put(r)
        return [r.wait(timeout=600)[0] for r in reqs]
    finally:
        b.stop()


def chunked_prefill(torch, np, cfg, device=None, max_len=2048, new=32,
                    chunk=128, lo=64, hi=1024):
    """An engine admitting in chunks of ``chunk`` tokens (interleaved with
    the decode bank) against monolithic admission, at PR 1's 8 prompts:
    first-token logits within 1e-3, every token equal through the decode
    bank (a decode step must not write a prefilling slot's blocks),
    blocks back to 0 in both."""
    from paddle_tpu_torch.flags import flag, set_flags
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import GenerationEngine, GenerationRequest
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    prompts = pr1_prompts(np, cfg, lo, hi)
    saved = flag("prefill_chunk_tokens")
    try:
        mono = GenerationEngine(gen, slots=8, paged=True, prefix_cache=False)
        t0 = time.perf_counter()
        want = run_requests(np, mono, prompts, new)
        mono_s = time.perf_counter() - t0
        set_flags({"prefill_chunk_tokens": chunk})
        chunked = GenerationEngine(gen, slots=8, paged=True,
                                   prefix_cache=False)
        worst = 0.0
        for p in prompts:
            tokens, pos_ids, last = gen._pack_prompts([p])
            ref, _, _ = gen.run_prefill(tokens, pos_ids, last)
            st = chunked.start_prefill(GenerationRequest(p), 0)
            while not chunked.prefill_chunk(st):
                pass
            worst = max(worst, (st["first_logits"] - ref[:1]).abs().max()
                        .item())
            chunked.release_slot(0)
        t0 = time.perf_counter()
        got = run_requests(np, chunked, prompts, new)
        chunk_s = time.perf_counter() - t0
    finally:
        set_flags({"prefill_chunk_tokens": saved})
    rec = card_line({
        "phase": "chunked_prefill", "chunk_tokens": chunk,
        "rows": len(prompts), "new_tokens": new,
        "first_token_logits_max_abs": worst, "atol": 1e-3,
        "token_agreement": float(np.mean([np.mean(a == b)
                                          for a, b in zip(got, want)])),
        "monolithic_wall_s": mono_s, "chunked_wall_s": chunk_s,
        "blocks_in_use_after": [mono.pool.blocks_in_use(),
                                chunked.pool.blocks_in_use()]})
    if worst > 1e-3 or rec["token_agreement"] != 1.0 \
            or any(rec["blocks_in_use_after"]):
        raise AssertionError(f"chunked_prefill: {rec}")
    return rec


def kv_migration(torch, np, cfg, device=None, max_len=2048, new=32,
                 lo=64, hi=1024, n=4):
    """Disaggregated prefill and decode between two in-process servers,
    per pool type (fp32, bf16, int8): the ``prefill`` op on one exports a
    prompt's KV blocks, the other decodes from them through
    ``generate(kv=, first_token=)``; the tokens equal the first server's
    own colocated paged serving bit for bit. Payload bytes; export and
    import ms (a pool of the same geometry)."""
    from paddle_tpu_torch.flags import flag, set_flags
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import Client, InferenceServer, KVBlockPool
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    prompts = pr1_prompts(np, cfg, lo, hi, n=n)
    saved = flag("kv_cache_dtype")
    rec = {"phase": "kv_migration", "prompts": n, "new_tokens": new}
    bad = []
    try:
        for kv_dtype in ("fp32", "bf16", "int8"):
            set_flags({"kv_cache_dtype": kv_dtype})
            pre = InferenceServer(generator=gen, decode_slots=2, paged=True)
            dec = InferenceServer(generator=gen, decode_slots=2, paged=True)
            try:
                pre.start()
                dec.start()
                with Client(pre.endpoint, timeout=600) as cp, \
                        Client(dec.endpoint, timeout=600) as cd:
                    payloads, same = [], []
                    for p in prompts:
                        colo = cp.generate(p, new)
                        kv = cp.prefill(p, new)
                        split = cd.generate(p, new, kv=kv)
                        payloads.append(kv)
                        same.append(bool(np.array_equal(colo, split)))
                st_pre, st_dec = pre.stats(), dec.stats()
            finally:
                pre.stop()
                dec.stop()
            pool = KVBlockPool(slots=1, num_layers=cfg.num_layers,
                               num_heads=cfg.num_heads, d_head=cfg.d_head,
                               max_seq_len=max_len, dtype=kv_dtype,
                               prefix_cache=False, device=gen.device)
            big = payloads[-1]
            pool.import_slot(0, big)                    # warm
            pool.free_slot(0)
            t0 = time.perf_counter()
            pool.import_slot(0, big)
            if gen.device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            pool.export_slot(0)
            t2 = time.perf_counter()
            rec[kv_dtype] = {
                "bitwise_vs_colocated": same,
                "payload_bytes": [KVBlockPool.payload_bytes(k)
                                  for k in payloads],
                "import_ms": (t1 - t0) * 1e3, "export_ms": (t2 - t1) * 1e3,
                "payload_tokens": big["tokens"],
                "kv_exports": st_pre["kv_exports"],
                "kv_imports": st_dec["kv_imports"],
                "blocks_in_use_after": [st_pre["kvpool_blocks_in_use"],
                                        st_dec["kvpool_blocks_in_use"]]}
            if not all(same) or any(rec[kv_dtype]["blocks_in_use_after"]) \
                    or st_dec["kv_imports"] != n:
                bad.append(kv_dtype)
    finally:
        set_flags({"kv_cache_dtype": saved})
    card_line(rec)
    if bad:
        raise AssertionError(f"kv_migration differs from colocated serving "
                             f"for {bad}")
    return rec


def server_full(torch, np, cfg, device=None, max_len=2048, new=32,
                spec_k=4, chunk=128, lo=64, hi=1024):
    """PR 1's server phase with every generation feature on: paged,
    prefix cache, chunked prefill (``chunk``) and speculative decoding
    (``spec_k``, n-gram drafter). 16 requests from 8 wire clients
    through 8 slots: PR 1's 8 prompts, then 8 built to exercise the
    prefix cache rather than taken from PR 1's traffic (request 8 + i is
    request i's prompt up to its last whole block, the cache's
    block-aligned entry, so a hit each, plus 24 tokens). Token p50 ms, tokens/s,
    acceptance, prefix hits; requests_completed == 16 and
    kvpool_blocks_in_use == 0 (hard); agreement with offline greedy
    reported."""
    from paddle_tpu_torch.flags import flag, set_flags
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import Client, InferenceServer
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    rng = np.random.default_rng(1)
    prompts = pr1_prompts(np, cfg, lo, hi)
    bs = flag("kv_block_size")
    prompts += [np.concatenate([p[:p.size // bs * bs], rng.integers(
        1, cfg.vocab_size, 24).astype(np.int32)]) for p in prompts]
    want = gen.generate(prompts[:8], max_new_tokens=new, paged=True) \
        + gen.generate(prompts[8:], max_new_tokens=new, paged=True)
    gen.release()
    keys = ("kv_prefix_cache", "prefill_chunk_tokens", "decode_spec_k")
    saved = {k: flag(k) for k in keys}
    set_flags({"kv_prefix_cache": True, "prefill_chunk_tokens": chunk,
               "decode_spec_k": spec_k})
    server = InferenceServer(generator=gen, decode_slots=8, paged=True)
    got, errors = {}, []

    def client(idxs):
        try:
            with Client(server.endpoint, timeout=600) as c:
                for i in idxs:
                    got[i] = c.generate(prompts[i], new)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        server.start()
        threads = [threading.Thread(target=client, args=((i, i + 8),))
                   for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"server clients failed: {errors}")
        st = server.stats()
    finally:
        server.stop()
        set_flags(saved)
    rec = card_line({
        "phase": "server_full", "requests": 16, "clients": 8, "slots": 8,
        "spec_k": spec_k, "chunk_tokens": chunk, "wall_s": wall,
        "tokens_per_s": 16 * new / wall,
        "token_p50_ms": st["token_p50_ms"],
        "spec_accept_ratio": st["spec_accept_ratio"],
        "spec_steps": st["spec_steps"],
        "prefix_hits": st["kvpool_prefix_hits"],
        "prefix_tokens_reused": st["kvpool_prefix_tokens_reused"],
        "cow_copies": st["kvpool_prefix_cow_copies"],
        "requests_completed": st["requests_completed"],
        "kvpool_blocks_in_use": st["kvpool_blocks_in_use"],
        "agreement_with_offline": float(np.mean(
            [np.mean(got[i] == want[i]) for i in range(16)]))})
    if rec["requests_completed"] != 16 or rec["kvpool_blocks_in_use"]:
        raise AssertionError(f"server_full: {rec}")
    return rec


# ------------------------------------------------------ BERT (Fluid)

# bench.py's two BERT-base trainers: bench_bert_long (flash attention,
# default AMP lists) and main(), the flagship (einsum attention with
# dropout, softmax on the AMP white list; B64 is the batch main() picks
# for a GPU)
BERT_LONG = {"name": "bert_long", "B": 16, "S": 2048, "P": 64,
             "mech": "flash", "white": ()}
BERT_FLAGSHIP = {"name": "bert_flagship", "B": 64, "S": 128, "P": 20,
                 "mech": None, "white": ("softmax",)}


def bert_train_flops_per_sample(cfg, seq_len, max_preds):
    """Analytic matmul FLOPs per sample of one BERT pretraining step,
    forward x3 for forward + backward (the formula of the repository's
    bench.py ``_bert_train_flops_per_sample``)."""
    h, L, ffn = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    v = cfg.vocab_size
    per_layer = (4 * 2 * seq_len * h * h + 2 * 2 * seq_len * h * ffn
                 + 2 * 2 * seq_len * seq_len * h)
    heads = 2 * max_preds * h * h + 2 * max_preds * h * v + 2 * h * h
    return 3 * (L * per_layer + heads)


def noam_lr(np, step, d_model, warmup=10000, scale=200.0):
    """The learning rate ``noam_decay(d_model, warmup, scale)`` gives at
    ``step``, in the program's float32 operations and order: scale *
    d_model^-0.5 * min(rsqrt(step), step * warmup^-1.5). Below step
    ``warmup`` the min is the linear term, so the value is exact IEEE
    float32 arithmetic (rsqrt's rounding does not enter)."""
    f = np.float32
    n = f(step)
    return f(scale * d_model ** -0.5) * min(f(1) / np.sqrt(n),
                                            n * f(warmup ** -1.5))


def bert_config(layers=None, mech=None, dropout=None, max_position=None):
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    cfg.attn_mechanism = mech
    if layers is not None:
        cfg.num_layers = layers
    if dropout is not None:
        cfg.hidden_dropout = cfg.attn_dropout = dropout
    if max_position is not None:
        cfg.max_position = max_position
    return cfg


def build_bert(cfg, B, S, P, white=(), lr=None):
    """``bert_pretrain`` + ``AdamOptimizer`` at ``noam_decay(768, 10000,
    200.0)`` (or a constant ``lr``), wrapped by ``mp.decorate`` at a
    static loss scale of 1.0 with ``white`` on the AMP white list, as
    bench.py trains. Returns (main, startup, outputs, lr var or value,
    params_grads)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        if lr is None:
            lr = fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0)
        opt = mp.decorate(
            fluid.optimizer.AdamOptimizer(lr),
            amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list=set(white)),
            init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out, lr, params_grads


def bert_train_phase(torch, np, run, steps, layers=None, place=None,
                     seed=0):
    """``steps`` steps of one of bench.py's BERT-base trainers (``run``:
    :data:`BERT_LONG` or :data:`BERT_FLAGSHIP`) through the Fluid surface
    on one seeded batch: finite losses, step 0 within 1.0 of ln(vocab) +
    ln(2) (the MLM and NSP losses of a random model), and each step's
    learning rate read back equal to :func:`noam_lr`. ``layers`` cuts the
    depth (a CPU rehearsal). Returns the phase record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    B, S, P = run["B"], run["S"], run["P"]
    cfg = bert_config(layers, run["mech"],
                      max_position=max(S, 512))
    main, startup, out, lr, _ = build_bert(cfg, B, S, P, run["white"])
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(seed))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, lrs, accs, wall = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, acc, lrv = exe.run(main, feed=feed, fetch_list=[
            out["loss"], out["nsp_acc"], lr], scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
        accs.append(float(np.ravel(acc)[0]))
        lrs.append(np.float32(np.ravel(lrv)[0]))
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = bert_train_flops_per_sample(cfg, S, P) * B
    want_lr = [noam_lr(np, i + 1, cfg.hidden_size) for i in range(steps)]
    start = float(np.log(cfg.vocab_size) + np.log(2))
    rec = {"phase": f"train_{run['name']}_amp_bf16", "B": B, "S": S,
           "P": P, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "vocab": cfg.vocab_size, "attention": run["mech"] or "einsum",
           "amp_white_extra": list(run["white"]),
           "dropout": cfg.hidden_dropout, "steps": steps,
           "losses": losses, "nsp_acc": accs,
           "lr": [float(x) for x in lrs],
           "lr_noam": [float(x) for x in want_lr],
           "lr_equal": [bool(a == b) for a, b in zip(lrs, want_lr)],
           "step_ms": wall, "median_step_ms_after_first": step_ms,
           "samples_per_s": B / step_ms * 1e3,
           "tokens_per_s": B * S / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "achieved_tflops": flops / step_ms / 1e9,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
           "ln_vocab_plus_ln2": start}
    bad = [x for x in losses if not np.isfinite(x)]
    if bad or abs(losses[0] - start) > 1.0 or not all(rec["lr_equal"]):
        emit(rec)
        raise AssertionError(f"BERT training is off: losses {losses}, "
                             f"lr {rec['lr']} vs {rec['lr_noam']}")
    return rec


def bert_verified_step(torch, np, layers=None, place=None, seed=4):
    """One ``bert_long`` step with FLAGS_verify_passes on: the executor
    verifies the program and validates each pass of the pipeline; raises
    nothing. Prints the verification's and the pipeline's ms."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.models import bert
    run = BERT_LONG
    cfg = bert_config(layers, run["mech"], max_position=run["S"])
    main, startup, out, _, _ = build_bert(cfg, run["B"], run["S"],
                                          run["P"])
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, run["B"], run["S"], run["P"],
                             rng=np.random.default_rng(seed))
    old = fluid.get_flags("FLAGS_verify_passes")
    fluid.set_flags({"FLAGS_verify_passes": True})
    try:
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[out["loss"]],
                      scope=scope)
        wall = (time.perf_counter() - t0) * 1e3
        st = passes.stats()
    finally:
        fluid.set_flags(old)
    rec = {"phase": "bert_verified_step", "layers": cfg.num_layers,
           "ops": len(main.global_block().ops),
           "verify_ms": exe.verify_ms, "pipeline_verify_ms": st["verify_ms"],
           "pass_total_ms": st["total_ms"], "step_ms": wall,
           "loss": float(np.ravel(lv)[0])}
    rec["ok"] = bool(np.isfinite(rec["loss"])) and exe.verify_ms > 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the verified BERT step is off: {rec}")
    return rec


def eval_bert_entry(torch, np, layers=None, place=None, seed=5):
    """``__graft_entry__.entry()``'s evaluation: BERT-base at B8 S128 P20
    through ``main.clone(for_test=True)`` (fp32, dropout as is_test): a
    finite loss, the same on a second run."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers)
    B, S, P = 8, 128, 20
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
    test = main.clone(for_test=True)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(seed))
    runs = [float(np.ravel(exe.run(test, feed=feed,
                                   fetch_list=[out["loss"]],
                                   scope=scope)[0])[0]) for _ in range(2)]
    rec = {"phase": "eval_bert_entry", "B": B, "S": S, "P": P,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "losses": runs}
    rec["ok"] = bool(np.isfinite(runs[0])) and runs[0] == runs[1]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"BERT evaluation is off: {rec}")
    return rec


def bert_small(torch, np, place=None, layers=2, B=8, S=2048, P=64):
    """BERT-base width, ``layers`` deep, flash, dropout 0, bf16 AMP:
    ``bert_grad_check`` (every param@GRAD through the kernels against the
    composite, within 2e-2 of its max |grad|, as GPT's AMP check) and
    ``bert_falls`` (5 steps at a constant lr 1e-4: step 4 below step 0;
    the bench's noam warmup, 7e-6 to 3.6e-5 over 5 steps, moves the loss
    less than the dropout noise would)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers, "flash", dropout=0.0, max_position=S)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(6))
    main, startup, _, _, params_grads = build_bert(cfg, B, S, P)
    grads_vs_composite(torch, np, f"bert_grad_check_B{B}_S{S}_amp_bf16",
                       cfg, main, startup, params_grads, feed, place, 2e-2)
    main, startup, out, _, _ = build_bert(cfg, B, S, P, lr=1e-4)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["loss"]],
                                     scope=scope)[0])[0])
              for _ in range(5)]
    rec = {"phase": "bert_falls", "layers": layers, "B": B, "S": S,
           "lr": 1e-4, "losses": losses}
    rec["ok"] = all(np.isfinite(losses)) and losses[-1] < losses[0]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"BERT's loss does not fall: {rec}")
    return rec


# ------------------------------------ image classification (ResNet, LeNet)

RESNET50 = {"depth": 50, "classes": 1000, "B": 128, "hw": 224}


def build_resnet(depth, classes, B, hw, lr=0.1, amp=False):
    """``resnet_train_program`` + ``Momentum(lr, 0.9)``; ``amp`` wraps it
    as bench.py's ``bench_resnet50`` does (bf16, batch_norm on the AMP
    white list, static loss scale 1.0). Returns (main, startup,
    outputs, params_grads)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(depth=depth, class_dim=classes,
                                          image_shape=(3, hw, hw),
                                          batch_size=B)
        opt = fluid.optimizer.Momentum(lr, 0.9)
        if amp:
            opt = mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list={"batch_norm"}), init_loss_scaling=1.0,
                use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out, params_grads


def conv_fc_flops_per_step(program):
    """Analytic FLOPs of one training step from the program's ``conv2d``
    and ``mul`` (fc) shapes: 2 x multiply-adds of the forward, x3 for
    the forward and the backward's two products."""
    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.type == "conv2d":
            o = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            macs += o[0] * o[1] * o[2] * o[3] * w[1] * w[2] * w[3]
        elif op.type == "mul":
            x = block.var(op.input("X")[0]).shape
            w = block.var(op.input("Y")[0]).shape
            macs += x[0] * w[0] * w[1]
    return 2 * macs * 3


def image_pool(torch, np, B, hw, classes, device, seed=0):
    """The two-batch seeded feed pool of bench.py's ``_device_pool``
    (normal images, uniform labels), staged on ``device``."""
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.standard_normal(
                (B, 3, hw, hw)).astype(np.float32)).to(device),
             "label": torch.from_numpy(rng.integers(
                 0, classes, (B, 1)).astype(np.int64)).to(device)}
            for _ in range(2)]


def resnet_train_phase(torch, np, run=RESNET50, steps=5, place=None,
                       seed=0):
    """``bench_resnet50``'s program (Momentum(0.1, 0.9), bf16 AMP with
    batch_norm white-listed) for ``steps`` steps over the two-batch
    pool: finite losses, the first within 1.0 of ln(classes); every
    conv2d output and batch_norm Y bf16 (in the program and, in one more
    step that fetches them, on the device); the moving mean and variance
    moved off (0, 1) in step 0 and float32; the pipeline's fused_momentum
    in place of the per-param updates. Returns (record, main, scope,
    executor)."""
    import paddle_tpu_torch as fluid
    main, startup, out, _ = build_resnet(run["depth"], run["classes"],
                                         run["B"], run["hw"], amp=True)
    block = main.global_block()
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device, seed)
    stats = [v.name for v in block.vars.values()
             if v.name.endswith(("_bn_mean", "_bn_variance"))]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall, moved = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=pool[i % 2], fetch_list=[out["loss"]],
                      scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
        if i == 0:
            moved = {
                "float32": all(scope.find_var(n).dtype == torch.float32
                               for n in stats),
                "changed": sum(not torch.equal(
                    scope.find_var(n), torch.zeros_like(scope.find_var(n))
                    if n.endswith("_mean") else
                    torch.ones_like(scope.find_var(n))) for n in stats),
                "of": len(stats)}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    outs = [op.output("Output" if op.type == "conv2d" else "Y")[0]
            for op in block.ops if op.type in ("conv2d", "batch_norm")]
    declared = {block.var(n).dtype for n in outs}
    vals = exe.run(main, feed=pool[0], fetch_list=outs, scope=scope,
                   return_numpy=False)
    on_device = {str(v.dtype) for v in vals}
    del vals
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = conv_fc_flops_per_step(main)
    start = float(np.log(run["classes"]))
    rec = {"phase": f"resnet{run['depth']}_train",
           "B": run["B"], "image": run["hw"], "classes": run["classes"],
           "optimizer": "Momentum(0.1, 0.9)",
           "amp": "bf16, batch_norm white-listed, static loss scale 1.0",
           "steps": steps, "losses": losses, "step_ms": wall,
           "median_step_ms_after_first": step_ms,
           "images_per_s": run["B"] / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "analytic_flops_per_image": flops / run["B"],
           "achieved_tflops": flops / step_ms / 1e9, "peak_mem_gb": peak,
           "conv_ops": sum(op.type == "conv2d" for op in block.ops),
           "conv_and_bn_outputs": len(outs),
           "declared_dtypes": sorted(declared),
           "device_dtypes": sorted(on_device),
           "moving_stats_after_step0": moved,
           "optimizer_ops_per_step": optimizer_ops(exe, main,
                                                   [out["loss"].name]),
           "ln_classes": start}
    ok = (all(np.isfinite(losses)) and abs(losses[0] - start) <= 1.0
          and declared == {"bfloat16"} and on_device == {"torch.bfloat16"}
          and moved["float32"] and moved["changed"] == moved["of"]
          and "momentum" not in rec["optimizer_ops_per_step"]
          and rec["optimizer_ops_per_step"].get("fused_momentum", 0) >= 1)
    if not ok:
        emit(rec)
        raise AssertionError(f"ResNet training is off: {rec}")
    return rec, scope, exe


def resnet_eval_phase(torch, np, scope, exe, run=RESNET50, seed=7):
    """``clone(for_test=True)`` of the fp32 ResNet program at the run's
    batch, over the trained scope, fetching loss and acc (and logits):
    finite, the same on a second (timed) run, and other logits than a
    train-mode forward (batch statistics) on the same batch gives."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(
            depth=run["depth"], class_dim=run["classes"],
            image_shape=(3, run["hw"], run["hw"]), batch_size=run["B"])
    test = main.clone(for_test=True)
    feed = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device, seed)[0]
    fetch = [out["loss"], out["acc"], out["logits"]]
    loss, acc, logits = exe.run(test, feed=feed, fetch_list=fetch,
                                scope=scope)
    t0 = time.perf_counter()            # the second run: warm
    again, _, _ = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    ms = (time.perf_counter() - t0) * 1e3
    train_logits, = exe.run(main, feed=feed, fetch_list=[out["logits"]],
                            scope=scope)
    diff = float(np.abs(train_logits - logits).max())
    rec = {"phase": f"resnet{run['depth']}_eval", "B": run["B"],
           "dtype": "float32", "loss": float(np.ravel(loss)[0]),
           "acc": float(np.ravel(acc)[0]), "warm_ms": ms,
           "batch_norm_is_test": all(op.attrs["is_test"] for op in
                                     test.global_block().ops
                                     if op.type == "batch_norm"),
           "max_abs_logit_diff_vs_train_forward": diff,
           "max_abs_logit": float(np.abs(logits).max())}
    rec["ok"] = (bool(np.isfinite(rec["loss"]))
                 and float(np.ravel(again)[0]) == rec["loss"]
                 and rec["batch_norm_is_test"]
                 and diff > 1e-3 * rec["max_abs_logit"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"ResNet evaluation is off: {rec}")
    return rec


def tiny_feed(torch, np, device, seed=0):
    """JAX's ``test_resnet18_tiny_trains`` batch (B8 32x32, 4 classes):
    normal images with a class-dependent offset on one channel."""
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    yv = rng.integers(0, 4, (8, 1)).astype(np.int64)
    for i in range(8):
        xv[i, yv[i, 0] % 3] += 1.5
    return {"image": torch.from_numpy(xv).to(device),
            "label": torch.from_numpy(yv).to(device)}


def resnet18_tiny_trains(torch, np, place=None, steps=12):
    """JAX's ``test_resnet18_tiny_trains``: ResNet-18, class_dim 4,
    32x32, B8, ``MomentumOptimizer(0.01, 0.9)``, fp32, 12 steps on one
    batch: the last loss below 0.7 x the first."""
    import paddle_tpu_torch as fluid
    main, startup, out, _ = build_resnet(18, 4, 8, 32, lr=0.01)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = tiny_feed(torch, np, exe.device)
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["loss"]],
                                     scope=scope)[0])[0])
              for _ in range(steps)]
    rec = {"phase": "resnet18_tiny_trains", "losses": losses,
           "limit": "last < 0.7 x first"}
    rec["ok"] = all(np.isfinite(losses)) and losses[-1] < 0.7 * losses[0]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"ResNet-18 does not train: {rec}")
    return rec


def resnet_grads(torch, np, place=None, limit=1e-3):
    """ResNet-18 at 32x32 B8 fp32: every param@GRAD with the bespoke
    ``conv2d_grad`` and ``batch_norm_grad`` against the generic vjp over
    the same lowerings (the bespoke grads switched off), each within
    ``limit`` of the generic grad's max |value|. cuDNN's TF32 setting
    (torch's default, not changed here) is in the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.registry import OPS
    from paddle_tpu_torch.models import resnet
    prog, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, start):
        o = resnet.resnet_train_program(depth=18, class_dim=4,
                                        image_shape=(3, 32, 32),
                                        batch_size=8)
        params_grads = fluid.append_backward(o["loss"])
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    feed = tiny_feed(torch, np, exe.device, seed=1)
    names = [g.name for _, g in params_grads]
    state = {n: v.clone() for n, v in scope.items()
             if isinstance(v, torch.Tensor)}
    bespoke = exe.run(prog, feed=feed, fetch_list=names, scope=scope)
    for n, v in state.items():          # the moving statistics moved
        scope.set(n, v)
    saved = {t: OPS[t].custom_grad_lower for t in ("conv2d", "batch_norm")}
    try:
        for t in saved:
            OPS[t].custom_grad_lower = None
        generic = exe.run(prog.clone(), feed=feed, fetch_list=names,
                          scope=scope)
    finally:
        for t, fn in saved.items():
            OPS[t].custom_grad_lower = fn
    errs = {n: float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
            for n, a, b in zip(names, bespoke, generic)}
    worst = max(errs, key=errs.get)
    rec = {"phase": "resnet_grads", "model": "ResNet-18 32x32 B8 fp32",
           "grads": len(names), "worst": worst, "worst_err": errs[worst],
           "limit": limit,
           "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}
    rec["ok"] = errs[worst] <= limit
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the bespoke grads disagree: {rec}")
    return rec


def synthetic_digits(np, n, seed=0):
    """Separable 28x28 digits (the JAX package's LeNet test data): class
    k lights up a distinct patch."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=(n, 1)).astype("int64")
    imgs = rng.randn(n, 1, 28, 28).astype("float32") * 0.1
    for i, k in enumerate(labels[:, 0]):
        r, c = divmod(int(k), 5)
        imgs[i, 0, r * 10:r * 10 + 8, c * 5:c * 5 + 4] += 1.0
    return imgs, labels


def lenet_train(torch, np, optimizer, lr, place=None, B=512, steps=32):
    """``build_lenet_train`` (``optimizer`` "adam" or "sgd") at
    bench_train_loop's on-card batch, ``steps`` ``Executor.run`` steps
    over a two-batch pool of synthetic digits on the device: steps/s,
    samples/s; finite losses, the last two below the first two."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train(lr=lr,
                                                      optimizer=optimizer)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    imgs, labels = synthetic_digits(np, 2 * B)
    pool = [{"img": torch.from_numpy(imgs[i * B:(i + 1) * B]).to(exe.device),
             "label": torch.from_numpy(labels[i * B:(i + 1) * B]).to(
                 exe.device)} for i in range(2)]
    exe.run(main, feed=pool[1], fetch_list=[fetches[0]], scope=scope)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        lv, = exe.run(main, feed=pool[i % 2], fetch_list=[fetches[0]],
                      scope=scope, return_numpy=False)
        losses.append(lv)
    losses = [float(v) for v in losses]         # one sync at the end
    sec = time.perf_counter() - t0
    rec = {"phase": f"lenet_train_{optimizer}", "B": B, "lr": lr,
           "steps": steps, "steps_per_s": steps / sec,
           "samples_per_s": steps * B / sec, "losses": losses,
           "optimizer_ops_per_step": optimizer_ops(exe, main,
                                                   [fetches[0].name])}
    rec["ok"] = (all(np.isfinite(losses))
                 and sum(losses[-2:]) < sum(losses[:2]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"LeNet does not train: {rec}")
    return rec


def fused_optimizers(torch, np, device=None, seed=0):
    """One step of ``fused_sgd``, ``fused_momentum`` (plain and Nesterov)
    and ``fused_adamw`` over ResNet-50's 161 parameter shapes on the
    device, each output held bitwise to its per-param op's; the fused
    bucket and the 161 per-param ops timed (CUDA events)."""
    from paddle_tpu_torch.framework.lowering import LowerCtx
    from paddle_tpu_torch.framework.registry import get_op_def
    from paddle_tpu_torch.models import resnet
    device = device or "cuda"
    shapes = [s for n, s in resnet.param_shapes(50, 1000).items()
              if not n.endswith(("_bn_mean", "_bn_variance"))]
    gen = torch.Generator(device=device).manual_seed(seed)

    def t(shape, lo=False):
        x = torch.randn(shape, generator=gen, device=device)
        return x.abs() if lo else x

    ctx = LowerCtx(None, None, {}, device)
    cases = {"sgd": ("sgd", {}),
             "momentum": ("momentum", {"mu": 0.9, "use_nesterov": False}),
             "momentum_nesterov": ("momentum", {"mu": 0.9,
                                                "use_nesterov": True}),
             "adamw": ("adamw", {"beta1": 0.9, "beta2": 0.999,
                                 "epsilon": 1e-8, "coeff": 0.01})}
    recs = []
    for case, (op, attrs) in cases.items():
        ins = {"Param": [t(s) for s in shapes],
               "Grad": [t(s) for s in shapes],
               "LearningRate": [torch.tensor(0.1, device=device)]}
        if op == "momentum":
            ins["Velocity"] = [t(s) for s in shapes]
        if op == "adamw":
            ins["Moment1"] = [t(s) for s in shapes]
            ins["Moment2"] = [t(s, lo=True) for s in shapes]
            ins["Beta1Pow"] = [torch.tensor(0.9 ** 3, device=device)
                               for _ in shapes]
            ins["Beta2Pow"] = [torch.tensor(0.999 ** 3, device=device)
                               for _ in shapes]
        fused_fn = get_op_def("fused_" + op).lower
        per_fn = get_op_def(op).lower

        def per_param():
            return [per_fn(ctx, {k: [v[i]] if len(v) > 1 else v
                                 for k, v in ins.items()}, attrs)
                    for i in range(len(shapes))]

        fused = fused_fn(ctx, ins, attrs)
        per = per_param()
        same = all(torch.equal(fused[slot][i], one[slot])
                   for i, one in enumerate(per) for slot in one)
        rec = {"phase": f"fused_optimizers_{case}", "params": len(shapes),
               "elements": sum(math.prod(s) for s in shapes),
               "bitwise_equal": bool(same)}
        if device != "cpu":
            rec["fused_ms"] = event_ms(torch, lambda: fused_fn(ctx, ins,
                                                               attrs), 5)
            rec["per_param_ms"] = event_ms(torch, per_param, 5)
        emit(rec)
        recs.append(rec)
        if not same:
            raise AssertionError(f"fused_{op} differs from {op}: {rec}")
    return recs



# ------------------------------------------------- saved-model serving

SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_models")
# bench.py bench_serving's traffic: a fresh server per request batch
# size, max_batch_size 64, batch_timeout_ms 2.0, warmup of the buckets
# (rb, 8 rb), 8 concurrent wire clients
SERVE_TRAFFIC = {"request_batches": (1, 8, 32), "clients": 8,
                 "requests_per_client": 8, "max_batch_size": 64,
                 "batch_timeout_ms": 2.0}
K1_KERNEL = "flash_fwd_kernel"


def resnet50_serving_program(classes=1000, hw=224, depth=50):
    """serve_resnet50's program: ``resnet_train_program(depth=50,
    class_dim=1000, batch_size=-1)`` with its seeded startup; the saved
    model serves ``logits`` from ``image``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(depth=depth, class_dim=classes,
                                          image_shape=(3, hw, hw),
                                          batch_size=-1)
    return main, startup, ["image"], [out["logits"]]


def bert_serving_program(cfg=None, S=128):
    """serve_bert_base's program: ``BertConfig.base()`` with flash
    attention, feeds ``src_ids``, ``sent_ids``, ``pos_ids`` and
    ``input_mask`` of ``[-1, S]``, the encoder at ``is_test=True``, the
    [CLS] row through ``pooled_fc`` (tanh) and ``next_sent_fc`` with
    softmax under bert_pretrain's parameter names; serves ``pooled``
    ``[B, 768]`` and the next-sentence probabilities ``[B, 2]``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = cfg or bert.BertConfig.base()
    cfg.attn_mechanism = "flash"
    main, startup = fluid.Program(), fluid.Program()
    names = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src, sent, pos, mask = (
            fluid.data(n, [-1, S], "float32" if n == "input_mask"
                       else "int32") for n in names)
        enc, _ = bert.bert_encoder(cfg, src, sent, pos, mask, is_test=True)
        cls = fluid.layers.reshape(fluid.layers.slice(
            enc, axes=[1], starts=[0], ends=[1]), [-1, cfg.hidden_size])
        pooled = fluid.layers.fc(cls, cfg.hidden_size,
                                 param_attr=bert._param(cfg, "pooled_fc.w_0"),
                                 bias_attr=bert._zero("pooled_fc.b_0"),
                                 act="tanh")
        probs = fluid.layers.softmax(fluid.layers.fc(
            pooled, 2, param_attr=bert._param(cfg, "next_sent_fc.w_0"),
            bias_attr=bert._zero("next_sent_fc.b_0")))
    return main, startup, names, [pooled, probs]


def image_request(np, rows, rng, hw=224):
    return {"image": rng.standard_normal((rows, 3, hw, hw))
            .astype(np.float32)}


def bert_request(np, rows, rng, S=128, vocab=30522):
    """Seeded token ids, segment ids, positions and a mask whose padded
    tail covers a random part of each row."""
    lens = rng.integers(S // 4, S + 1, (rows, 1))
    return {"src_ids": rng.integers(0, vocab, (rows, S), dtype=np.int32),
            "sent_ids": (np.arange(S) >= lens // 2).astype(np.int32),
            "pos_ids": np.broadcast_to(np.arange(S, dtype=np.int32),
                                       (rows, S)).copy(),
            "input_mask": (np.arange(S) < lens).astype(np.float32)}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def flip_last_byte(path):
    """Corrupt a saved file: its last byte inverted."""
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))


def io_roundtrip(torch, np, place=None, B=8, **model):
    """Persistence at ResNet-50's full width (``model`` shrinks it for a
    CPU rehearsal): ``save_persistables`` then ``load_persistables`` into
    a fresh scope gives the same bits; ``save_inference_model`` then an
    ``AnalysisPredictor`` over the saved directory gives the eval
    clone's logits bit for bit at B8; a bf16 tensor round-trips bitwise;
    one flipped byte in a ``.npy`` raises ``CheckpointCorruptError``
    naming the file. Prints the save and load ms and the bytes."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.resilience import CheckpointCorruptError
    root = os.path.join(SERVE_DIR, "io_roundtrip")
    shutil.rmtree(root, ignore_errors=True)
    pdir, mdir, bdir = (os.path.join(root, n)
                        for n in ("persistables", "model", "bf16"))
    main, startup, feeds, targets = resnet50_serving_program(**model)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    dev = exe.device
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    rec = {"phase": "io_roundtrip", "model": "resnet50" if not model
           else f"resnet{model.get('depth', 50)}"}
    t0 = time.perf_counter()
    fluid.save_persistables(exe, pdir, main_program=main, scope=scope)
    rec["save_persistables_ms"] = (time.perf_counter() - t0) * 1e3
    rec["persistables_bytes"] = dir_bytes(pdir)
    fresh = fluid.Scope()
    t0 = time.perf_counter()
    fluid.load_persistables(exe, pdir, main_program=main, scope=fresh)
    sync()
    rec["load_persistables_ms"] = (time.perf_counter() - t0) * 1e3
    names = [v.name for v in main.list_vars() if v.persistable]
    rec["vars"] = len(names)
    rec["persistables_bitwise"] = all(
        fresh.find_var(n).device == scope.find_var(n).device
        and torch.equal(fresh.find_var(n), scope.find_var(n))
        for n in names)

    t0 = time.perf_counter()
    fluid.save_inference_model(mdir, feeds, targets, exe,
                               main_program=main, scope=scope)
    rec["save_inference_model_ms"] = (time.perf_counter() - t0) * 1e3
    rec["model_bytes"] = dir_bytes(mdir)
    cfg = inference.AnalysisConfig(mdir)
    if dev.type == "cpu":
        cfg.disable_gpu()
    t0 = time.perf_counter()
    pred = inference.create_predictor(cfg)
    sync()
    rec["load_inference_model_ms"] = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(11)
    hw = model.get("hw", 224)
    feed = image_request(np, B, rng, hw)
    logits, = pred.run([feed["image"]])
    test = main.clone(for_test=True)
    feed["label"] = np.zeros((B, 1), np.int64)
    ref, = exe.run(test, feed=feed, fetch_list=targets, scope=scope)
    rec["predictor_logits_bitwise"] = bool(np.array_equal(logits, ref))
    rec["logits_shape"] = list(logits.shape)

    bits = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (64, 768),
                                         dtype=np.int16))
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80          # no NaN/inf
    prog = fluid.Program()
    prog.global_block().create_var(name="w_bf16", shape=[64, 768],
                                   dtype="bfloat16", persistable=True)
    bscope = fluid.Scope()
    bscope.set("w_bf16", bits.view(torch.bfloat16).to(dev))
    fluid.io.save_vars(exe, bdir, main_program=prog, scope=bscope,
                       predicate=fluid.io.is_persistable)
    back = fluid.Scope()
    fluid.io.load_vars(exe, bdir, main_program=prog, scope=back,
                       predicate=fluid.io.is_persistable)
    got = back.find_var("w_bf16")
    rec["bf16_bitwise"] = got.dtype == torch.bfloat16 and torch.equal(
        got.view(torch.int16).cpu(), bits)

    flip_last_byte(os.path.join(pdir, "fc_0.w_0.npy"))
    try:
        fluid.load_persistables(exe, pdir, main_program=main,
                                scope=fluid.Scope())
        rec["corrupt_raised"] = None
    except CheckpointCorruptError as e:
        rec["corrupt_raised"] = os.path.basename(e.path or "")
    shutil.rmtree(root, ignore_errors=True)
    rec["ok"] = (rec["persistables_bitwise"]
                 and rec["predictor_logits_bitwise"] and rec["bf16_bitwise"]
                 and rec["corrupt_raised"] == "fc_0.w_0.npy")
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"io round trip failed: {rec}")
    return rec


def serve_traffic(torch, np, name, build, request, place=None,
                  traffic=SERVE_TRAFFIC, scope=None):
    """The saved model under bench_serving's traffic: save the program
    (over ``scope``, a trained model's, or else its seeded startup's),
    then for each request batch size rb a fresh
    ``InferenceServer(model_dir)`` warmed at the buckets of (rb, 8 rb)
    answers ``clients`` concurrent wire clients, each sending
    ``requests_per_client`` requests of its own rb rows. Returns what
    :func:`check_served` needs; the servers are stopped, their engines
    (and captured graphs) kept."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    d = os.path.join(SERVE_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    main, startup, feeds, targets = build()
    exe = fluid.Executor(place)
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    fluid.save_inference_model(d, feeds, targets, exe, main_program=main,
                               scope=scope)
    del scope
    cuda = exe.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"name": name, "dir": d, "feeds": feeds, "runs": {}}
    for rb in traffic["request_batches"]:
        server = serving.InferenceServer(
            d, place=place, max_batch_size=traffic["max_batch_size"],
            batch_timeout_ms=traffic["batch_timeout_ms"], queue_depth=1024)
        t0 = time.perf_counter()
        server.start(warmup_batch_sizes=(rb, 8 * rb))
        warm_s = time.perf_counter() - t0
        rng = np.random.default_rng(rb)
        sent = [request(np, rb, rng) for _ in range(traffic["clients"])]
        replies, lat, errors = {}, [], []

        def client(i):
            try:
                with serving.Client(server.endpoint, timeout=600) as c:
                    for j in range(traffic["requests_per_client"]):
                        t = time.perf_counter()
                        replies[(i, j)] = c.infer(sent[i])
                        lat.append(time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(traffic["clients"])]
        try:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            st = server.stats()
        finally:
            server.stop()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve_{name} rb {rb}: clients failed: "
                                 f"{errors}")
        n = len(replies)
        lat_ms = np.sort(np.array(lat)) * 1e3
        out["runs"][rb] = {
            "engine": server.engine, "sent": sent, "replies": replies,
            "record": {
                "request_batch": rb, "requests": n, "wall_s": wall,
                "warmup_s": warm_s, "requests_per_s": n / wall,
                "samples_per_s": n * rb / wall,
                "p50_ms": float(np.percentile(lat_ms, 50)),
                "p99_ms": float(np.percentile(lat_ms, 99)),
                "server_total_p50_ms": st["total_p50_ms"],
                "server_total_p99_ms": st["total_p99_ms"],
                "execute_mean_ms": st["execute_mean_ms"],
                "queue_mean_ms": st["queue_mean_ms"],
                "mean_batch_size": st["mean_batch_size"],
                "batch_occupancy": st["batch_occupancy"],
                "batches": st["batches"], "compiles": st["compiles"],
                "compile_mean_ms": st["compile_mean_ms"],
                "cache_hits": st["cache_hits"],
                "cache_misses": st["cache_misses"],
                "requests_completed": st["requests_completed"],
                "requests_failed": st["requests_failed"]}}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def check_served(torch, np, served, launches, k1_per_batch, place=None,
                 tol=1e-4):
    """What serve_traffic's run must show: every reply within ``tol`` of
    max |ref| of ``AnalysisPredictor.run`` on that request alone; at
    rb 1 a mean batch size above 1 and a cache hit; per bucket, the
    graph replay of one padded batch equal bit for bit to an eager run
    of it, with eager and replay ms (events) and the graph's bytes; K1
    launched ``k1_per_batch`` times per executed batch by the counters
    (each capture's eager pass runs the program once too) and, where it
    should launch, in one profiled replay."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import Request
    cfg = inference.AnalysisConfig(served["dir"])
    if place is not None and not hasattr(place, "device_id"):
        cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    feeds = served["feeds"]
    failures, rows, buckets = [], [], []
    executions = 0
    for rb, run in served["runs"].items():
        rec = dict(run["record"])
        worst = 0.0
        for i, sent in enumerate(run["sent"]):
            ref = pred.run([sent[n] for n in feeds])
            for (ci, _), outs in run["replies"].items():
                if ci != i:
                    continue
                for g, r in zip(outs, ref):
                    if g.shape != r.shape or not np.isfinite(g).all():
                        failures.append(f"rb {rb}: reply shape "
                                        f"{g.shape} != {r.shape}")
                    worst = max(worst, float(np.abs(g - r).max())
                                / max(float(np.abs(r).max()), 1e-30))
        rec["max_rel_err_vs_predictor"] = worst
        rec["tol"] = tol
        if worst > tol:
            failures.append(f"rb {rb}: replies {worst} of max |ref| from "
                            f"the predictor")
        if rb == 1 and not (rec["mean_batch_size"] > 1
                            and rec["cache_hits"] >= 1):
            failures.append(f"rb 1: mean batch {rec['mean_batch_size']}, "
                            f"cache hits {rec['cache_hits']}")
        executions += rec["batches"] + rec["compiles"]
        rows.append(rec)
        engine = run["engine"]
        for sig, entry in engine.cache.items():
            bucket = dict((n, s) for n, s, _ in sig)[feeds[0]][0]
            k = max(bucket // rb, 1)
            reqs = [Request(run["sent"][i % len(run["sent"])])
                    for i in range(k)]
            feed, nrows, _ = engine.pad_batch(reqs)
            replay = entry.run(feed)
            eager = entry.eager(feed)
            row = {"request_batch": rb, "bucket": bucket, "rows": nrows,
                   "bitwise": all(np.array_equal(a, b)
                                  for a, b in zip(replay, eager)),
                   "graph_bytes": entry.nbytes}
            if entry.graph is not None:
                row["eager_ms"] = event_ms(
                    torch, lambda e=entry: e._run_ops(e._bufs), 3)
                row["replay_ms"] = event_ms(torch, entry.graph.replay, 10)
                row["replay_speedup"] = row["eager_ms"] / row["replay_ms"]
            if not row["bitwise"]:
                failures.append(f"rb {rb} bucket {bucket}: replay differs "
                                f"from an eager run")
            buckets.append(row)
    k1 = launches["flash_attention_fwd"]
    rec = {"phase": f"serve_{served['name']}", "runs": rows,
           "buckets": buckets, "k1_launches": k1,
           "executions": executions,
           "k1_per_execution": k1 / max(executions, 1),
           "peak_bytes": served.get("peak_bytes")}
    if k1 != k1_per_batch * executions:
        failures.append(f"K1 launched {k1} times in {executions} executed "
                        f"batches, not {k1_per_batch} each")
    if k1_per_batch and served["runs"]:
        run = next(iter(served["runs"].values()))
        entry = next(iter(run["engine"].cache.values()))
        if entry.graph is not None:
            try:
                _, names, seen = traced_count(torch, entry.graph.replay,
                                              K1_KERNEL, k1_per_batch)
                rec["profiled_replay"] = {
                    "kernels": len(names), "k1_launches": seen[-1][0],
                    "k1_and_kernels_per_trace": seen}
            except AssertionError as e:
                failures.append(f"profiled replays: {e}")
    rec["ok"] = not failures
    emit(rec)
    for run in served["runs"].values():
        run.clear()
    if failures:
        raise AssertionError(f"serve_{served['name']}: {failures}")
    return rec


def capture_refuses_host_sync(torch, np):
    """A program whose op syncs the host (``.item()``) cannot be
    captured: ``CapturedProgram`` raises ``GraphCaptureError`` naming the
    op, and nothing runs it eagerly instead; after it, 1 GiB allocated
    and freed on a side stream leaves no reserved memory behind
    ``empty_cache``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import (CapturedProgram,
                                                       GraphCaptureError)
    from paddle_tpu_torch.framework.registry import OPS, register_op
    if "chip_smoke_host_sync" not in OPS:
        @register_op("chip_smoke_host_sync", infer_shape=False)
        def _host_sync(ctx, ins, attrs):
            x = ins["X"][0]
            return {"Out": x * float(x.sum().item())}
    prog = fluid.Program()
    blk = prog.global_block()
    blk.create_var(name="x", shape=[-1, 4], dtype="float32", is_data=True)
    blk.create_var(name="y", shape=[-1, 4], dtype="float32")
    blk.append_op(type="relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                  infer_shape=False)
    blk.create_var(name="out", shape=[-1, 4], dtype="float32")
    blk.append_op(type="chip_smoke_host_sync", inputs={"X": ["y"]},
                  outputs={"Out": ["out"]}, infer_shape=False)
    feed = {"x": np.ones((2, 4), np.float32)}
    rec = {"phase": "capture_refuses_host_sync"}
    try:
        CapturedProgram(prog, feed, ["out"], fluid.Scope(), "cuda")
        rec["raised"] = None
    except GraphCaptureError as e:
        rec.update(raised=type(e).__name__, op_type=e.op_type,
                   op_index=e.op_index, message=str(e)[:300])
    # the card still works after the refused capture, and the caching
    # allocator still frees what it caches (an invalidated capture that
    # was never ended leaves it counting a capture underway: empty_cache
    # then frees nothing, and every later path's memory stays reserved)
    t = torch.ones(4, device="cuda")
    rec["after"] = float((t * 2).sum().item())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    with torch.cuda.stream(torch.cuda.Stream()):
        big = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec["reserved_gb_left_of_1gib"] = \
        (torch.cuda.memory_reserved() - base) / 1e9
    rec["ok"] = rec["raised"] == "GraphCaptureError" \
        and rec["op_type"] == "chip_smoke_host_sync" and \
        rec["after"] == 8.0 and rec["reserved_gb_left_of_1gib"] < 0.1
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"a host-syncing op was captured or fell "
                             f"back: {rec}")
    return rec


# --------------------------- the training loop (run_steps, guard, dataset)

CARD = {"card": None}     # the nvidia-smi line, set by main()


def scope_diff(torch, a, b):
    """Names whose values differ (bitwise) between two scopes."""
    out = sorted(set(a.keys()) ^ set(b.keys()))
    for n in set(a.keys()) & set(b.keys()):
        va, vb = a.find_var(n), b.find_var(n)
        if isinstance(va, torch.Tensor):
            if va.shape != vb.shape or va.dtype != vb.dtype or \
                    not torch.equal(va, vb.to(va.device)):
                out.append(n)
        elif va != vb:
            out.append(n)
    return out


def profiled_trace(torch, fn):
    """(device ms, {kernel name: launches}) of one call of ``fn`` from
    torch.profiler: the CUDA kernels in its trace (a graph replay's
    included; copies and sets add to the time, not the count; the
    markers of :func:`trace_markers` to neither)."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, names = 0.0, Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "spin_kernel" in e.name:
            continue
        t = getattr(e, "device_time", None)
        us += float(e.cuda_time if t is None else t)
        if not e.name.startswith(("Memcpy", "Memset")):
            names[e.name] += 1
    return us / 1e3, names


def traced_count(torch, fn, match, want, tries=3):
    """Kernel records whose name holds ``match`` in a profiler trace of
    ``fn``, a graph replay (the same kernels every call), held to
    ``want``. A trace that shows another count is taken again, up to
    ``tries`` in all, and counts as one that lost records only when it
    holds fewer kernel records in all than the trace that shows
    ``want``; a trace never shows more than ``want``. Each trace opens
    with :func:`trace_markers`, which take the loss of a trace's first
    records late in this script. Returns (device ms, {kernel name:
    launches} and [[matched, kernel records]] of the traces, the
    accepted one last) and raises AssertionError otherwise."""
    seen = []
    for _ in range(tries):
        ms, names = profiled_trace(
            torch, lambda: (trace_markers(torch, True), fn()))
        seen.append([sum(n for k, n in names.items() if match in k),
                     sum(names.values())])
        if seen[-1][0] >= want:
            break
    got, total = seen[-1]
    lossy = all(m < want and t < total for m, t in seen[:-1])
    if got != want or not lossy:
        raise AssertionError(
            f"{match}: traces of one replay showed [launches, kernel "
            f"records] {seen}, not {want} launches (a retried trace must "
            f"hold fewer records in all than the one that shows {want})")
    return ms, names, seen


def profiled_launches(torch, fn):
    """(device ms, kernel launches) of one call of ``fn`` (see
    :func:`profiled_trace`)."""
    ms, names = profiled_trace(torch, fn)
    return ms, sum(names.values())


def profiled_ms(torch, fn):
    """Device time (ms) of one call of ``fn`` from torch.profiler (see
    :func:`profiled_launches`); None when the trace holds no device
    time."""
    return profiled_launches(torch, fn)[0] or None


def build_bert_graft(cfg, B, S, P, recompute, white=()):
    """BERT pretraining as ``__graft_entry__._build(with_opt=True)``
    composes it: ``bert_pretrain`` + ``AdamOptimizer(noam_decay(h, 100,
    learning_rate=1.0))`` under ``RecomputeOptimizer`` with the layer
    outputs as checkpoints (``recompute`` False leaves it out), wrapped
    by ``mp.decorate`` (bf16 AMP at a static loss scale of 1.0, as
    bench.py's bench_bert_long trains). Returns (main, startup, outputs,
    lr var)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.noam_decay(cfg.hidden_size, 100, learning_rate=1.0)
        opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(out["checkpoints"])
        mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
            custom_white_list=set(white)), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(out["loss"])
    return main, startup, out, lr


def _stack(np, feeds):
    return {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}


def _captured(exe):
    """The executor's newest captured step (``CapturedStep``)."""
    return list(exe._graphs.values())[-1]


def _sync(torch, exe):
    if exe.device.type == "cuda":
        torch.cuda.synchronize()


def bert_long_recompute(torch, np, fa, place=None, layers=None, B=16,
                        S=2048, P=64, K=4, seed=11):
    """The slice's path: BERT-base at bench_bert_long's shape (B16 S2048
    P64, flash, bf16 AMP) as ``__graft_entry__`` builds it, noam Adam
    under ``RecomputeOptimizer`` with the 12 layer checkpoints, from one
    seeded startup:

    (a) K eager ``Executor.run`` steps and one ``run_steps`` slab of K
        from copies of that scope: losses, the noam LR and the final
        scope bitwise; (b) the program without recompute, one slab from
        another copy: its losses beside (a)'s, and the peak memory of
        each slab (``max_memory_allocated`` over the first slab, the
        warm-up pass and the capture included, less what was allocated
        before it; and the graph pool's bytes); (c) K1 and K2 launches a
        step, eager and per replay: 24 and 12 with recompute, 12 and 12
        without; (d) wall ms a step eager and by ``run_steps`` (a second
        slab), device ms a step (torch.profiler), the idle share, tokens/s
        and TFLOP/s (bench.py's formula: the recomputed forward is not
        useful work) and the LR read back against noam_decay's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    k1, k2 = fa.flash_attention_fwd, fa.flash_attention_bwd_single
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    slab = _stack(np, feeds)
    rec = {"phase": "bert_long_recompute", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "attention": "flash", "amp": "bf16", "lr": "noam_decay(h, 100, 1.0)"}
    failures = []
    scope0 = None
    runs = {}
    for rc in (False, True):
        main, startup, out, lr = build_bert_graft(cfg, B, S, P, rc)
        if scope0 is None:
            scope0 = fluid.Scope()
            exe.run(startup, scope=scope0)
        fetch = [out["loss"], lr]
        key = "recompute" if rc else "no_recompute"
        r = runs[key] = {}
        sB = copied_scope(torch, fluid, scope0)
        _sync(torch, exe)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        before = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        got = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=sB)
        r["first_slab_s"] = time.perf_counter() - t0
        entry = _captured(exe)
        if cuda:
            r["peak_gb_over_first_slab"] = \
                (torch.cuda.max_memory_allocated() - base) / 1e9
            r["graph_pool_gb"] = entry.nbytes / 1e9
        warm = {w.__name__: n for (w, a), n in
                entry.warmup_launches.items() if a == "launches"}
        rep = {w.__name__: n for (w, a), n in
               entry.replay_launches.items() if a == "launches"}
        r["k1_per_step_slab"] = (k1.launches - before[0]
                                 - warm.get(k1.__name__, 0)) / K
        r["k2_per_step_slab"] = (k2.launches - before[1]
                                 - warm.get(k2.__name__, 0)) / K
        r["replay_launches"] = rep
        r["losses"] = [float(x) for x in got[0]]
        r["lr"] = [float(x) for x in np.ravel(got[1])]
        if rc:
            # (a) K eager steps from another copy of the same scope
            sA = copied_scope(torch, fluid, scope0)
            before = (k1.launches, k2.launches)
            eager, wall = [], []
            for f in feeds:
                t0 = time.perf_counter()
                eager.append(exe.run(main, feed=f, fetch_list=fetch,
                                     scope=sA))
                wall.append((time.perf_counter() - t0) * 1e3)
            r["k1_per_step_eager"] = (k1.launches - before[0]) / K
            r["k2_per_step_eager"] = (k2.launches - before[1]) / K
            r["eager_losses"] = [float(e[0]) for e in eager]
            r["losses_bitwise_eager"] = bool(np.array_equal(
                got[0], np.stack([e[0] for e in eager]))) and bool(
                np.array_equal(got[1], np.stack([e[1] for e in eager])))
            diff = scope_diff(torch, sA, sB)
            r["scope_bitwise_eager"] = not diff
            r["scope_diff"] = diff[:8]
            r["eager_ms_per_step"] = wall
            if not (r["losses_bitwise_eager"] and not diff):
                failures.append(f"run_steps is not its eager steps: "
                                f"{r['losses']} vs {r['eager_losses']}, "
                                f"scope diff {diff[:8]}")
            want = [noam_lr(np, i + 1, cfg.hidden_size, 100, 1.0)
                    for i in range(K)]
            r["lr_noam"] = [float(x) for x in want]
            if [np.float32(x) for x in r["lr"]] != want:
                failures.append(f"noam LR {r['lr']} != {r['lr_noam']}")
            # (d) a second slab (the captured step replayed), timed, then
            # profiled; one eager step profiled
            t0 = time.perf_counter()
            exe.run_steps(main, feed=slab, fetch_list=fetch, scope=sB)
            r["run_steps_ms_per_step"] = \
                (time.perf_counter() - t0) * 1e3 / K
            r["eager_ms_per_step_median"] = float(np.median(wall[1:])) \
                if K > 1 else wall[0]
            if cuda:
                r["device_ms_per_step_run_steps"] = profiled_ms(
                    torch, lambda: exe.run_steps(main, feed=slab,
                                                 fetch_list=fetch,
                                                 scope=sB)) / K
                r["device_ms_per_step_eager"] = profiled_ms(
                    torch, lambda: exe.run(main, feed=feeds[0],
                                           fetch_list=fetch, scope=sA))
                for how in ("run_steps", "eager"):
                    wall_ms = r["run_steps_ms_per_step"] \
                        if how == "run_steps" \
                        else r["eager_ms_per_step_median"]
                    r[f"idle_share_{how}"] = \
                        1 - r[f"device_ms_per_step_{how}"] / wall_ms
            flops = bert_train_flops_per_sample(cfg, S, P) * B
            ms = r["run_steps_ms_per_step"]
            r["tokens_per_s_run_steps"] = B * S / ms * 1e3
            r["tflops_run_steps"] = flops / ms / 1e9
            r["tokens_per_s_eager"] = \
                B * S / r["eager_ms_per_step_median"] * 1e3
            r["analytic_flops_per_step"] = flops
            del sA
        exe.close()
        del sB, got
        _sync(torch, exe)
        if cuda:
            torch.cuda.empty_cache()
    a, b = runs["recompute"], runs["no_recompute"]
    rec.update(runs)
    rec["losses_bitwise_with_without_recompute"] = a["losses"] == b["losses"]
    L = cfg.num_layers
    want = {"recompute": (2 * L, L), "no_recompute": (L, L)}
    for key, (w1, w2) in want.items() if cuda else ():
        r = runs[key]
        got = (r["k1_per_step_slab"], r["k2_per_step_slab"])
        if got != (w1, w2) or (key == "recompute" and (
                r["k1_per_step_eager"], r["k2_per_step_eager"]) != (w1, w2)):
            failures.append(f"{key}: K1/K2 a step {got} (eager "
                            f"{r.get('k1_per_step_eager')}, "
                            f"{r.get('k2_per_step_eager')}), not {(w1, w2)}")
    if cuda and not a["peak_gb_over_first_slab"] < \
            b["peak_gb_over_first_slab"]:
        failures.append(f"recompute peaks at {a['peak_gb_over_first_slab']}"
                        f" GB, no lower than {b['peak_gb_over_first_slab']}")
    if not all(np.isfinite(a["losses"])):
        failures.append(f"non-finite losses {a['losses']}")
    rec["ok"] = not failures
    emit(rec)
    if failures:
        raise AssertionError(f"bert_long_recompute: {failures}")
    return rec


def capture_names_flash_grad(torch, np, B=2, S=256, P=4):
    """A training step whose flash grad op syncs the host (``.item()``
    slipped into its backward call) cannot be captured: ``run_steps``
    raises ``GraphCaptureError`` naming ``flash_attention_grad``, nothing
    runs the slab eagerly instead, and the scope keeps its state. The
    unpatched step then captures: K2's wrapper itself makes no host
    sync and no allocation outside the graph pool."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention_ops
    cfg = bert_config(1, "flash", max_position=512)
    main, startup, out, _ = build_bert_graft(cfg, B, S, P, True)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    before = copied_scope(torch, fluid, scope)
    rng = np.random.default_rng(15)
    slab = _stack(np, [bert.random_batch(cfg, B, S, P, rng=rng)
                       for _ in range(2)])
    real = attention_ops.flash_attention_bwd

    def syncing(q, *a):
        float(q.float().sum().item())
        return real(q, *a)
    rec = {"phase": "capture_names_flash_grad", **CARD, "raised": None}
    attention_ops.flash_attention_bwd = syncing
    try:
        exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                      scope=scope)
    except GraphCaptureError as e:
        rec.update(raised=type(e).__name__, op_type=e.op_type,
                   message=str(e)[:300])
    finally:
        attention_ops.flash_attention_bwd = real
    rec["scope_untouched"] = not scope_diff(torch, scope, before)
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=scope)[0]
    rec["then_captures"] = bool(np.isfinite(got).all())
    rec["ok"] = (rec["raised"] == "GraphCaptureError"
                 and rec["op_type"] == "flash_attention_grad"
                 and rec["scope_untouched"] and rec["then_captures"])
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"capture_names_flash_grad: {rec}")
    return rec


def flagship_steps(torch, np, place=None, layers=None, K=8, seed=12):
    """bench.py main()'s flagship (BERT-base B64 S128 P20, einsum
    attention, BERT's dropout 0.1, bf16 AMP with softmax white-listed,
    noam Adam): K eager steps against one ``run_steps`` slab of K from
    copies of one scope: losses and scope bitwise (each replay draws its
    eager step's dropout masks); wall and device ms a step both ways, and
    the idle share."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    run = BERT_FLAGSHIP
    B, S, P = run["B"], run["S"], run["P"]
    cfg = bert_config(layers, run["mech"], max_position=512)
    main, startup, out, lr, _ = build_bert(cfg, B, S, P, run["white"])
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    slab = _stack(np, feeds)
    sA = copied_scope(torch, fluid, scope0)
    sB = copied_scope(torch, fluid, scope0)
    eager, wall = [], []
    for f in feeds:
        t0 = time.perf_counter()
        eager.append(exe.run(main, feed=f, fetch_list=[out["loss"]],
                             scope=sA)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=sB)[0]
    diff = scope_diff(torch, sA, sB)
    rec = {"phase": "flagship_steps", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "dropout": cfg.hidden_dropout,
           "attention": "einsum", "amp": "bf16",
           "eager_losses": [float(x) for x in eager],
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
           "scope_bitwise": not diff, "scope_diff": diff[:8],
           "eager_ms_per_step": wall,
           "eager_ms_per_step_median": float(np.median(wall[1:]))}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[out["loss"]], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if exe.device.type == "cuda":
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab,
                                         fetch_list=[out["loss"]],
                                         scope=sB)) / K
        rec["device_ms_per_step_eager"] = profiled_ms(
            torch, lambda: exe.run(main, feed=feeds[0],
                                   fetch_list=[out["loss"]], scope=sA))
        rec["idle_share_eager"] = 1 - rec["device_ms_per_step_eager"] / \
            rec["eager_ms_per_step_median"]
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["graph_pool_gb"] = _captured(exe).nbytes / 1e9
        rec["stochastic_call_sites"] = len(_captured(exe)._sites)
    rec["samples_per_s_run_steps"] = B / rec["run_steps_ms_per_step"] * 1e3
    rec["ok"] = rec["losses_bitwise"] and not diff and \
        bool(np.isfinite(got).all())
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"flagship_steps: run_steps is not its eager "
                             f"steps: {rec}")
    return rec


def train_loop_lenet(torch, np, place=None, B=512, warm=32, steps=128):
    """bench.py's bench_train_loop on the port: ``build_lenet_train()``
    (Adam 0.001) at B512 over a two-batch seeded pool staged on the
    device (step i takes batch i % 2), K in {1, 8, 32}: K=1 is one
    ``Executor.run`` a step, K > 1 one ``run_steps`` slab of K; equal
    step counts (``warm`` steps, then ``steps`` timed). Steps/s and
    samples/s for each K; the losses of every K bitwise K=1's, under
    ``FLAGS_cudnn_deterministic`` (the port's default). With
    the flag turned off, two eager runs of
    ``warm`` steps are compared and the verdict recorded (cuDNN's
    default wgrad and dgrad may sum in another order from call to
    call)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    pool = lenet_pool(np, B)
    with deterministic_convs(fluid, False):
        runs = [eager_losses(torch, np, fluid, place, main, startup,
                             fetches[0].name, pool, warm) for _ in range(2)]
    with deterministic_convs(fluid):
        rec = _train_loop_lenet(torch, np, place, B, warm, steps)
    rec["eager_runs_bitwise_without_flag"] = bool(
        np.array_equal(runs[0], runs[1]))
    emit(rec)
    return rec


def lenet_pool(np, B):
    rng = np.random.default_rng(0)
    return [{"img": rng.standard_normal((B, 1, 28, 28)).astype(np.float32),
             "label": rng.integers(0, 10, (B, 1)).astype(np.int64)}
            for _ in range(2)]


def eager_losses(torch, np, fluid, place, main, startup, loss, pool, n):
    """``n`` eager LeNet steps from a fresh startup (step i takes batch
    i % 2): the losses."""
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rows = [{k: torch.from_numpy(v).to(exe.device) for k, v in b.items()}
            for b in pool]
    out = [exe.run(main, feed=rows[i % 2], fetch_list=[loss], scope=scope,
                   return_numpy=False)[0].reshape(1) for i in range(n)]
    return torch.cat(out).float().cpu().numpy()


class deterministic_convs:
    """``FLAGS_cudnn_deterministic`` set to ``on`` inside, as it was
    after."""

    def __init__(self, fluid, on=True):
        self.fluid = fluid
        self.on = on

    def __enter__(self):
        self.old = self.fluid.get_flags("FLAGS_cudnn_deterministic")
        self.fluid.set_flags({"FLAGS_cudnn_deterministic": self.on})

    def __exit__(self, *exc):
        self.fluid.set_flags(self.old)


def _train_loop_lenet(torch, np, place, B, warm, steps):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    loss = fetches[0].name
    pool = lenet_pool(np, B)
    per_k, losses = {}, {}
    for k in (1, 8, 32):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        staged = {n: torch.from_numpy(np.stack(
            [pool[j % 2][n] for j in range(k)])).to(exe.device)
            for n in pool[0]}
        rows = [{n: torch.from_numpy(v).to(exe.device)
                 for n, v in b.items()} for b in pool]

        def one(k=k, exe=exe, scope=scope, staged=staged, rows=rows, i=[0]):
            if k == 1:
                out = exe.run(main, feed=rows[i[0] % 2], fetch_list=[loss],
                              scope=scope, return_numpy=False)
                i[0] += 1
                return out[0].reshape(1)
            return exe.run_steps(main, feed=staged, fetch_list=[loss],
                                 scope=scope, return_numpy=False)[0]
        outs = [one() for _ in range(warm // k)]
        _sync(torch, exe)
        t0 = time.perf_counter()
        outs += [one() for _ in range(steps // k)]
        lv = torch.cat(outs).float().cpu().numpy()      # the one sync
        sec = time.perf_counter() - t0
        losses[k] = lv
        per_k[str(k)] = {"steps_per_s": steps / sec,
                         "samples_per_s": steps * B / sec}
        exe.close()
    base = per_k["1"]["steps_per_s"]
    for row in per_k.values():
        row["speedup_vs_k1"] = row["steps_per_s"] / base
    rec = {"phase": "train_loop_lenet", **CARD, "B": B,
           "cudnn_deterministic": True, "warm_steps": warm,
           "timed_steps": steps, "k": per_k,
           "losses_bitwise_k1": {str(k): bool(np.array_equal(losses[k],
                                                             losses[1]))
                                 for k in (8, 32)},
           "first_last_loss": [float(losses[1][0]), float(losses[1][-1])]}
    rec["ok"] = all(rec["losses_bitwise_k1"].values()) and \
        bool(np.isfinite(losses[1]).all())
    if not rec["ok"]:
        emit(rec)
        raise AssertionError(f"train_loop_lenet: {rec}")
    return rec


def nonfinite_steps(torch, np, place=None, layers=2, B=16, S=2048, P=64,
                    K=8, bad=3, seed=13):
    """The slice's BERT program (:func:`build_bert_graft`, recompute) at
    ``layers`` deep: a K-step slab with a NaN in step ``bad``'s
    ``input_mask`` (the only float feed). ``check_nan_inf`` raises
    ``NonFiniteError`` naming fused step ``bad``; ``skip_nonfinite_steps``
    rolls back that step only: the scope bitwise a sequential
    ``run(skip_nonfinite_steps=True)`` over the same K feeds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.resilience import NonFiniteError
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    main, startup, out, lr = build_bert_graft(cfg, B, S, P, True)
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    feeds[bad]["input_mask"] = feeds[bad]["input_mask"].copy()
    feeds[bad]["input_mask"][0, 0] = np.nan
    slab = _stack(np, feeds)
    rec = {"phase": "nonfinite_steps", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "bad_step": bad}
    try:
        exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                      scope=copied_scope(torch, fluid, scope0),
                      check_nan_inf=True)
        rec["raised"] = None
    except NonFiniteError as e:
        rec.update(raised=type(e).__name__, message=str(e)[:300],
                   var_name=e.var_name, count=e.count)
    sA = copied_scope(torch, fluid, scope0)
    sB = copied_scope(torch, fluid, scope0)
    seq = [exe.run(main, feed=f, fetch_list=[out["loss"]], scope=sA,
                   skip_nonfinite_steps=True)[0] for f in feeds]
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=sB, skip_nonfinite_steps=True)[0]
    diff = scope_diff(torch, sA, sB)
    rec.update(losses=[float(x) for x in got],
               losses_bitwise=bool(np.array_equal(got, np.stack(seq),
                                                  equal_nan=True)),
               scope_bitwise=not diff, scope_diff=diff[:8],
               nonfinite_steps=[int(i) for i in np.flatnonzero(
                   ~np.isfinite(got))])
    rec["ok"] = (rec["raised"] == "NonFiniteError"
                 and f"fused step {bad}/{K} " in rec["message"]
                 and rec["losses_bitwise"] and not diff
                 and rec["nonfinite_steps"] == [bad])
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"nonfinite_steps: {rec}")
    return rec


def train_from_dataset_phase(torch, np, place=None, B=64, K=8, slabs=3,
                             tail=5, seed=14):
    """``Executor.train_from_dataset`` over a ``QueueDataset`` of seeded
    LeNet samples that the phase writes to a temp dir (``slabs`` x K
    batches of B, then ``tail`` more): ``steps_per_run=K`` (run_steps
    slabs, the short tail slab through ``run``) against
    ``steps_per_run=1`` from copies of one scope: the end state and the
    last loss bitwise (under ``FLAGS_cudnn_deterministic``)."""
    import paddle_tpu_torch as fluid
    with deterministic_convs(fluid):
        return _train_from_dataset(torch, np, place, B, K, slabs, tail,
                                   seed)


def _train_from_dataset(torch, np, place, B, K, slabs, tail, seed):
    import shutil
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    n = (slabs * K + tail) * B
    imgs, labels = synthetic_digits(np, n, seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        paths = []
        for part in range(2):
            path = os.path.join(tmp, f"part-{part}.txt")
            with open(path, "w") as f:
                for i in range(part, n, 2):
                    f.write("img:" + ",".join(
                        f"{v:.5f}" for v in imgs[i].ravel())
                        + f" label:{int(labels[i, 0])}\n")
            paths.append(path)

        def parse(line):
            g = dict(t.split(":", 1) for t in line.split())
            return (np.array(g["img"].split(","), np.float32).reshape(
                1, 28, 28), np.array([int(g["label"])], np.int64))
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_filelist(paths)
        ds.set_batch_size(B)
        block = main.global_block()
        ds.set_use_var([block.var("img"), block.var("label")])
        ds.set_line_parser(parse)
        sA = copied_scope(torch, fluid, scope0)
        sB = copied_scope(torch, fluid, scope0)
        t0 = time.perf_counter()
        fused = exe.train_from_dataset(main, ds, scope=sA,
                                       fetch_list=[fetches[0]],
                                       print_period=0, steps_per_run=K)
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = exe.train_from_dataset(main, ds, scope=sB,
                                      fetch_list=[fetches[0]],
                                      print_period=0, steps_per_run=1)
        step_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = scope_diff(torch, sA, sB)
    rec = {"phase": "train_from_dataset", **CARD, "B": B,
           "cudnn_deterministic": True,
           "steps_per_run": K, "batches": slabs * K + tail,
           "fused_s": fused_s, "stepwise_s": step_s,
           "last_loss": float(step[0]),
           "last_loss_bitwise": bool(np.array_equal(fused[0][-1], step[0])),
           "scope_bitwise": not diff, "scope_diff": diff[:8]}
    rec["ok"] = rec["last_loss_bitwise"] and not diff
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"train_from_dataset: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Wide&Deep CTR (bench.py's bench_widedeep) with SelectedRows grads, and
# the FLAGS_cudnn_deterministic A/B
# ---------------------------------------------------------------------------

WIDEDEEP = {"B": 4096, "dense_dim": 13, "num_slots": 26,
            "vocab_size": 10000, "embed_dim": 16,
            "hidden_sizes": (400, 400, 400), "lr": 1e-3}


def widedeep_model_kw(cfg):
    return {k: cfg[k] for k in ("dense_dim", "num_slots", "vocab_size",
                                "embed_dim", "hidden_sizes")}


def widedeep_program(cfg, lazy=False):
    """bench_widedeep's program: ``wide_deep(batch_size=B)`` +
    ``Adam(lr)`` (``lazy_mode`` as given). Returns (main, startup,
    outputs)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import widedeep
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = widedeep.wide_deep(batch_size=cfg["B"],
                                 **widedeep_model_kw(cfg))
        fluid.optimizer.Adam(cfg["lr"], lazy_mode=lazy).minimize(
            out["loss"])
    return main, startup, out


def widedeep_pool(torch, np, cfg, device, seed=0):
    """bench_widedeep's two-batch seeded pool (``random_batch`` from one
    ``default_rng(seed)``), staged on ``device``."""
    from paddle_tpu_torch.models import widedeep
    rng = np.random.default_rng(seed)
    pool = [widedeep.random_batch(cfg["B"], cfg["dense_dim"],
                                  cfg["num_slots"], cfg["vocab_size"],
                                  rng=rng) for _ in range(2)]
    return [{n: torch.from_numpy(a).to(device) for n, a in b.items()}
            for b in pool]


def widedeep_slab(torch, pool, K):
    """K steps over the pool (step i takes batch i % 2), stacked."""
    return {n: torch.stack([pool[i % 2][n] for i in range(K)])
            for n in pool[0]}


def _peak_from(torch, cuda, base):
    return (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda \
        else None


def _peak_base(torch, cuda):
    if not cuda:
        return None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def widedeep_train(torch, np, place=None, cfg=WIDEDEEP, K=8):
    """bench_widedeep on the port: Wide&Deep (B4096, dense 13, 26 slots
    over a vocab of 10000, embed 16, MLP 400x3) with Adam(1e-3), non-lazy
    (the 52 tables' SelectedRows grads densified in their per-param adam
    ops), over the two-batch pool, from copies of one seeded startup:
    K eager ``Executor.run`` steps against one ``run_steps`` slab of K
    (losses and scope bitwise, no ``GraphCaptureError``), and a second
    slab of K from a third copy (tables bitwise run to run); the losses
    finite, the first near ln 2, step K-2 below step 0 (the same batch);
    wall and device ms a step both ways, the idle share, samples/s, the
    peak memory over the eager steps and over the first slab, the op
    count of the program as built and as the pass pipeline leaves it,
    and the adam ops left per-param (one per table). Returns (record,
    the trained scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    main, startup, out = widedeep_program(cfg)
    loss = out["loss"]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    pool = widedeep_pool(torch, np, cfg, exe.device)
    slab = widedeep_slab(torch, pool, K)
    B = cfg["B"]
    sA, sB, sC = (copied_scope(torch, fluid, scope0) for _ in range(3))
    del scope0
    failures = []
    base = _peak_base(torch, cuda)
    eager, wall = [], []
    for i in range(K):
        t0 = time.perf_counter()
        eager.append(exe.run(main, feed=pool[i % 2], fetch_list=[loss],
                             scope=sA)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    peak_eager = _peak_from(torch, cuda, base)
    base = _peak_base(torch, cuda)
    try:
        t0 = time.perf_counter()
        got = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)[0]
        first_slab_s = time.perf_counter() - t0
    except GraphCaptureError as e:
        raise AssertionError(f"widedeep_train: the step did not capture: "
                             f"{e}") from e
    peak_slab = _peak_from(torch, cuda, base)
    again = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sC)[0]
    diff = scope_diff(torch, sA, sB)
    tables = [n for n in sB.keys() if "embedding_" in n and
              n.endswith(".w")]
    run_to_run = [n for n in scope_diff(torch, sB, sC) if n in tables]
    opt = passes.optimize_program(main, [loss.name])
    upd = optimizer_ops(exe, main, [loss.name])
    ln2 = float(np.log(2.0))
    rec = {"phase": "widedeep_train", **CARD, "B": B,
           **widedeep_model_kw(cfg), "optimizer": f"Adam({cfg['lr']})",
           "K": K, "eager_losses": [float(x) for x in eager],
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
           "scope_bitwise": not diff, "scope_diff": diff[:8],
           "tables": len(tables),
           "tables_bitwise_run_to_run": not run_to_run
           and bool(np.array_equal(got, again)),
           "ops_as_built": len(main.global_block().ops),
           "ops_after_passes": len(opt.global_block().ops),
           "optimizer_ops_per_step": upd,
           "adam_unfused": upd.get("adam", 0),
           "eager_ms_per_step": wall,
           "eager_ms_per_step_median": float(np.median(wall[1:])),
           "first_slab_s": first_slab_s,
           "peak_gb_eager": peak_eager, "peak_gb_over_first_slab": peak_slab}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if cuda:
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab, fetch_list=[loss],
                                         scope=sB)) / K
        rec["device_ms_per_step_eager"] = profiled_ms(
            torch, lambda: exe.run(main, feed=pool[0], fetch_list=[loss],
                                   scope=sA))
        rec["idle_share_eager"] = 1 - rec["device_ms_per_step_eager"] / \
            rec["eager_ms_per_step_median"]
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["graph_pool_gb"] = _captured(exe).nbytes / 1e9
    rec["samples_per_s_eager"] = B / rec["eager_ms_per_step_median"] * 1e3
    rec["samples_per_s_run_steps"] = B / rec["run_steps_ms_per_step"] * 1e3
    losses = rec["eager_losses"]
    if not (rec["losses_bitwise"] and not diff):
        failures.append(f"run_steps is not its eager steps: scope diff "
                        f"{diff[:8]}")
    if not rec["tables_bitwise_run_to_run"]:
        failures.append(f"two slabs from one start differ: {run_to_run[:8]}")
    if rec["adam_unfused"] != 2 * cfg["num_slots"] or \
            rec["tables"] != 2 * cfg["num_slots"]:
        failures.append(f"{rec['adam_unfused']} adam ops per-param for "
                        f"{rec['tables']} tables")
    if not (all(np.isfinite(losses)) and abs(losses[0] - ln2) < 0.1
            and losses[K - 2] < losses[0]):
        failures.append(f"losses {losses}")
    rec["ok"] = not failures
    exe.close()
    del sA, sC
    emit(rec)
    if failures:
        raise AssertionError(f"widedeep_train: {failures}")
    return rec, sB


def plain_lazy_adam(torch, p, m1, m2, rows, values, lr, b1p, b2p,
                    b1=0.9, b2=0.999, eps=1e-8):
    """The plain version of lazy Adam over one table, in float64: the
    sparse grad summed into a dense one (``index_add_``), the dense Adam
    update, then only the rows the grad names kept (the others as
    they were)."""
    d = torch.float64
    g = torch.zeros(p.shape, dtype=d, device=p.device).index_add_(
        0, rows, values.to(d))
    m1n = b1 * m1.to(d) + (1 - b1) * g
    m2n = b2 * m2.to(d) + (1 - b2) * g * g
    lr_t = lr * math.sqrt(1 - b2p) / (1 - b1p)
    pn = p.to(d) - lr_t * m1n / (torch.sqrt(m2n) + eps)
    hit = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    hit[rows] = True
    keep = lambda new, old: torch.where(hit[:, None], new,  # noqa: E731
                                        old.to(d))
    return keep(pn, p), keep(m1n, m1), keep(m2n, m2)


def widedeep_lazy_adam(torch, np, place=None, cfg=WIDEDEEP, K=8, seed=3,
                       tol=1e-5):
    """bench_widedeep's shape with ``lazy_mode=True``: a ``run_steps``
    slab of K captures (no host sync in the sort and row updates of
    ``selected_rows.coalesce``) and is bitwise K eager steps; every
    table's rows no batch of the pool touched keep their param bits and
    moments exactly zero, and the touched rows moved. Then the lazy
    ``adam`` op on one trained table with the pool's duplicate ids and a
    seeded grad against :func:`plain_lazy_adam` (param and moments within
    ``tol`` of max |ref|, float32); wall and device ms a step by
    ``run_steps``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    from paddle_tpu_torch.framework.lowering import LowerCtx
    from paddle_tpu_torch.framework.registry import get_op_def
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    main, startup, out = widedeep_program(cfg, lazy=True)
    loss = out["loss"]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    pool = widedeep_pool(torch, np, cfg, exe.device)
    slab = widedeep_slab(torch, pool, K)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    failures = []
    try:
        got = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)[0]
    except GraphCaptureError as e:
        raise AssertionError(f"widedeep_lazy_adam: the lazy step did not "
                             f"capture: {e}") from e
    eager = [exe.run(main, feed=pool[i % 2], fetch_list=[loss],
                     scope=sA)[0] for i in range(K)]
    diff = scope_diff(torch, sA, sB)
    untouched_nonzero, moved, rows_untouched = [], 0, 0
    for i in range(cfg["num_slots"]):
        hit = torch.zeros(cfg["vocab_size"], dtype=torch.bool,
                          device=exe.device)
        for b in pool:
            hit[b[f"C{i}"].reshape(-1)] = True
        cold = ~hit
        rows_untouched += int(cold.sum())
        for t in (f"embedding_{i}.w", f"wide_embedding_{i}.w"):
            m1 = sB.find_var(f"{t}_moment1_0")
            m2 = sB.find_var(f"{t}_moment2_0")
            same = torch.equal(sB.find_var(t)[cold], scope0.find_var(t)[cold])
            if m1[cold].any() or m2[cold].any() or not same:
                untouched_nonzero.append(t)
            moved += int(bool(m1[hit].any()))
    # the lazy adam op on one table, duplicate ids, against the plain one
    name = "embedding_0.w"
    p, m1, m2 = (sB.find_var(n) for n in
                 (name, f"{name}_moment1_0", f"{name}_moment2_0"))
    rows = pool[0]["C0"].reshape(-1)
    gen = torch.Generator(device=exe.device).manual_seed(seed)
    values = torch.randn((rows.shape[0], cfg["embed_dim"]), generator=gen,
                         device=exe.device)
    b1p, b2p = 0.9 ** (K + 1), 0.999 ** (K + 1)
    full = lambda v: torch.full((1,), v, dtype=torch.float32,  # noqa: E731
                                device=exe.device)
    outs = get_op_def("adam").lower(
        LowerCtx(None, None, {}, exe.device),
        {"Param": [p], "Grad": [SelectedRows(rows, values)],
         "LearningRate": [full(cfg["lr"])], "Moment1": [m1],
         "Moment2": [m2], "Beta1Pow": [full(b1p)], "Beta2Pow": [full(b2p)]},
        {"lazy_mode": True})
    ref = plain_lazy_adam(torch, p, m1, m2, rows, values, cfg["lr"],
                          float(np.float32(b1p)), float(np.float32(b2p)))
    errs = {}
    for key, r in zip(("ParamOut", "Moment1Out", "Moment2Out"), ref):
        errs[key] = float((outs[key].double() - r).abs().max()
                          / r.abs().max().clamp_min(1e-30))
    dup = rows.shape[0] - int(torch.unique(rows).shape[0])
    rec = {"phase": "widedeep_lazy_adam", **CARD, "B": cfg["B"],
           **widedeep_model_kw(cfg), "K": K, "lazy_mode": True,
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise_eager": bool(np.array_equal(got,
                                                       np.stack(eager))),
           "scope_bitwise_eager": not diff, "scope_diff": diff[:8],
           "untouched_rows": rows_untouched,
           "tables_with_untouched_rows_changed": untouched_nonzero,
           "tables_whose_touched_moments_moved": moved,
           "op_check_table": name, "op_check_duplicate_ids": dup,
           "op_check_rel_err": errs, "tol": tol}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if cuda:
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab, fetch_list=[loss],
                                         scope=sB)) / K
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
    rec["samples_per_s_run_steps"] = \
        cfg["B"] / rec["run_steps_ms_per_step"] * 1e3
    if not (rec["losses_bitwise_eager"] and not diff):
        failures.append(f"run_steps is not its eager steps: {diff[:8]}")
    if untouched_nonzero or moved != 2 * cfg["num_slots"] \
            or not rows_untouched:
        failures.append(f"untouched rows changed in {untouched_nonzero[:4]}"
                        f", {moved} tables moved, {rows_untouched} untouched")
    if max(errs.values()) > tol or not dup:
        failures.append(f"lazy adam vs plain: {errs} ({dup} duplicates)")
    if not np.isfinite(got).all():
        failures.append(f"losses {rec['run_steps_losses']}")
    rec["ok"] = not failures
    exe.close()
    emit(rec)
    if failures:
        raise AssertionError(f"widedeep_lazy_adam: {failures}")
    return rec


def widedeep_serving_program(cfg=WIDEDEEP):
    """widedeep_serve's program: ``wide_deep(batch_size=-1)`` under the
    trained program's parameter names, ``clone(for_test=True)``; serves
    ``predict`` (the click probability) from ``dense_input`` and the
    slot ids."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import widedeep
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = widedeep.wide_deep(batch_size=-1, **widedeep_model_kw(cfg))
    names = ["dense_input"] + [f"C{i}" for i in range(cfg["num_slots"])]
    return main.clone(for_test=True), startup, names, [out["predict"]]


def widedeep_request(np, rows, rng, cfg=WIDEDEEP):
    req = {"dense_input": rng.standard_normal(
        (rows, cfg["dense_dim"])).astype(np.float32)}
    for i in range(cfg["num_slots"]):
        req[f"C{i}"] = rng.integers(0, cfg["vocab_size"],
                                    (rows, 1)).astype(np.int64)
    return req


def cudnn_deterministic_ab(torch, np, place=None, run=RESNET50, reps=2,
                           lenet_B=512, lenet_steps=16):
    """Queue 3's fault 3: what ``FLAGS_cudnn_deterministic`` costs and
    buys. bench_resnet50's step (B128 bf16 AMP, Momentum) with the flag
    off and on, in turns (off, on, on, off) x ``reps`` after a warm-up
    of each: device ms a step (torch.profiler) and wall ms; one step from
    two copies of one scope with the flag on and off (every state tensor
    bitwise, or not); two eager LeNet runs of ``lenet_steps`` steps
    under each setting, their losses bitwise or not (bitwise under the
    flag, as train_loop_lenet finds, or the phase fails)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    main, startup, out, _ = build_resnet(run["depth"], run["classes"],
                                         run["B"], run["hw"], amp=True)
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device)
    loss = out["loss"]

    def step(sc=scope):
        return exe.run(main, feed=pool[0], fetch_list=[loss], scope=sc)[0]

    for on in (False, True):
        with deterministic_convs(fluid, on):
            step()
            step()
    dev = {False: [], True: []}
    wall = {False: [], True: []}
    for on in (False, True, True, False) * reps:
        with deterministic_convs(fluid, on):
            if cuda:
                dev[on].append(profiled_ms(torch, step))
            t0 = time.perf_counter()
            step()
            wall[on].append((time.perf_counter() - t0) * 1e3)
    bitwise = {}
    for on in (False, True):
        scopes = [copied_scope(torch, fluid, scope) for _ in range(2)]
        with deterministic_convs(fluid, on):
            for sc in scopes:
                step(sc)
        bitwise[on] = not scope_diff(torch, *scopes)
        del scopes
    with fluid.unique_name.guard():
        lmain, lstart, _, fetches = build_lenet_train()
    lpool = lenet_pool(np, lenet_B)
    lenet = {}
    for on in (False, True):
        with deterministic_convs(fluid, on):
            runs = [eager_losses(torch, np, fluid, place, lmain, lstart,
                                 fetches[0].name, lpool, lenet_steps)
                    for _ in range(2)]
        lenet[on] = bool(np.array_equal(runs[0], runs[1]))
    key = {False: "off", True: "on"}
    rec = {"phase": "cudnn_deterministic_ab", **CARD, "B": run["B"],
           "depth": run["depth"], "amp": "bf16", "order": "off on on off",
           "reps": reps,
           "wall_ms": {key[k]: v for k, v in wall.items()},
           "resnet_step_bitwise": {key[k]: v for k, v in bitwise.items()},
           "lenet_eager_runs_bitwise": {key[k]: v for k, v in lenet.items()},
           "lenet_B": lenet_B, "lenet_steps": lenet_steps}
    if cuda:
        rec["device_ms"] = {key[k]: v for k, v in dev.items()}
        off, on = (float(np.median(dev[k])) for k in (False, True))
        rec["device_ms_median"] = {"off": off, "on": on}
        rec["cost_of_flag"] = on / off - 1
    rec["ok"] = lenet[True]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"cudnn_deterministic_ab: two LeNet runs "
                             f"differ under the flag: {rec}")
    return rec


# bench.py bench_dygraph_transformer (:463-532): Transformer(8000, 8000,
# max_len=64), Transformer-base widths, Adam(1e-4), a pool of 4 batches
# of B256 src 32 tgt 32
DY_TRANSFORMER = {"B": 256, "src": 32, "tgt": 32, "vocab": 8000,
                  "d_model": 512, "heads": 8, "d_inner": 2048, "layers": 6,
                  "max_len": 64, "dropout": 0.1, "lr": 1e-4, "pool": 4,
                  "warm_rows": 8, "timed": 20}
DY_TR_KEYS = ("src_ids", "src_mask", "tgt_ids", "labels", "label_mask")


def transformer_train_flops(run):
    """FLOP of one training step of the Transformer at ``run``'s shape,
    counted as bench.py's ``_*_train_flops_per_sample`` helpers count:
    3 x (2 x the multiply-adds of the forward GEMMs and attention
    products); dropout, softmax, LayerNorm, the loss and Adam left out,
    as are the forwards the generic grads recompute (not useful work).
    Per source token: an encoder layer's Q, K, V, O (4 d^2) and FFN
    (2 d d_inner); per target token: a decoder layer's self and cross
    attention (8 d^2) and FFN, and the output projection (d x vocab);
    per token and attention: the score and context products (2 T d)."""
    d, di, L = run["d_model"], run["d_inner"], run["layers"]
    src_tok, tgt_tok = run["B"] * run["src"], run["B"] * run["tgt"]
    enc = L * (4 * d * d + 2 * d * di + 2 * run["src"] * d)
    dec = L * (8 * d * d + 2 * d * di + 2 * run["tgt"] * d
               + 2 * run["src"] * d) + d * run["vocab"]
    return 3 * 2 * (src_tok * enc + tgt_tok * dec)


def _dy_state(model, opt):
    """Copies of every parameter and optimizer slot of a dygraph model."""
    return ([p.value.clone() for p in model.parameters()],
            {pn: {s: t.clone() for s, t in st.items()}
             for pn, st in opt._eager_state.items()})


def _dy_restore(model, opt, state):
    params, slots = state
    for p, v in zip(model.parameters(), params):
        p.value = v.clone()
    opt._eager_state = {pn: {s: t.clone() for s, t in st.items()}
                        for pn, st in slots.items()}


def _dy_bitwise(torch, model, opt, state):
    """Names of the parameters and slots that differ from ``state``."""
    params, slots = state
    out = [p.name for p, v in zip(model.parameters(), params)
           if not torch.equal(p.value, v)]
    out += [f"{pn}.{s}" for pn, st in slots.items() for s, t in st.items()
            if not torch.equal(opt._eager_state[pn][s], t)]
    return out


def _dy_step(fluid, dygraph, model, opt):
    """bench.py's step function under dygraph.jit_step."""
    @dygraph.jit_step
    def step(*args):
        loss = model(*args)
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss
    return step


def _timed_wall(torch, cuda, fn):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dygraph_transformer(torch, np, place=None, run=DY_TRANSFORMER, seed=0,
                        eager_steps=4, name="dygraph_transformer",
                        opt_kw=None):
    """bench.py's bench_dygraph_transformer on the port: the dygraph
    Transformer at ``run``'s shape under ``dygraph.guard(place)``, Adam
    1e-4, a pool of 4 seeded batches staged on the device. One eager
    warm-up step on ``warm_rows`` rows; ``eager_steps`` eager steps at the
    full batch (``CompiledStep.eager``: wall ms, the median of steps 1 on,
    device ms and kernel launches of one); the capture at the full batch
    (its seconds, the graph pool's bytes) and its replay; ``timed``
    replays on the host clock with one sync at the end (ms/step,
    samples/s, target tokens/s, TFLOP/s by ``transformer_train_flops``);
    device ms and launches of one replay; the peaks. Gates: every loss
    finite; one replay from a copied state equals one eager step from
    the same state and tracer key bitwise (the loss, every parameter and
    every Adam slot; dropout on). ``opt_kw`` goes to the Adam (a
    ``grad_clip``, a ``regularization``); ``name`` names the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models import transformer
    rng = np.random.default_rng(seed)
    B = run["B"]
    with dygraph.guard(place):
        tracer = dygraph.base._current_tracer()
        dev = tracer.device
        cuda = dev.type == "cuda"
        model = transformer.Transformer(
            run["vocab"], run["vocab"], d_model=run["d_model"],
            n_head=run["heads"], d_inner=run["d_inner"],
            n_layer=run["layers"], max_len=run["max_len"],
            dropout=run["dropout"])
        opt = fluid.optimizer.Adam(run["lr"],
                                   parameter_list=model.parameters(),
                                   **(opt_kw or {}))
        pool = [transformer.random_batch(B, run["src"], run["tgt"],
                                         run["vocab"], run["vocab"], rng=rng)
                for _ in range(run["pool"])]
        staged = [[torch.from_numpy(b[k]).to(dev) for k in DY_TR_KEYS]
                  for b in pool]
        step = _dy_step(fluid, dygraph, model, opt)
        cs = step._compiled_step
        n_params = sum(p.value.numel() for p in model.parameters())
        warm = [t[:run["warm_rows"]] for t in staged[0]]
        losses = [float(step(*warm).numpy().reshape(-1)[0])]
        base = _peak_base(torch, cuda)
        eager_ms = []
        for i in range(eager_steps):
            out, ms = _timed_wall(torch, cuda,
                                  lambda i=i: cs.eager(*staged[i % 4]))
            losses.append(float(out.numpy().reshape(-1)[0]))
            eager_ms.append(ms)
        rec = {"phase": name, **CARD, "B": B,
               "src_len": run["src"], "tgt_len": run["tgt"],
               "vocab": run["vocab"], "d_model": run["d_model"],
               "layers": run["layers"], "dropout": run["dropout"],
               "params": n_params, "eager_ms_per_step": eager_ms,
               "eager_ms_per_step_median": float(np.median(eager_ms[1:]))}
        if cuda:
            rec["peak_gb_eager"] = _peak_from(torch, cuda, base)
            rec["device_ms_eager"], rec["launches_eager"] = \
                profiled_launches(torch, lambda: cs.eager(*staged[0]))
        base = _peak_base(torch, cuda)
        out, first_ms = _timed_wall(torch, cuda, lambda: step(*staged[0]))
        losses.append(float(out.numpy().reshape(-1)[0]))
        entry = next(iter(cs._cache.values()))
        rec.update(capture_s=entry.capture_s, first_call_ms=first_ms,
                   graph_pool_gb=entry.nbytes / 1e9,
                   stochastic_call_sites=len(entry._sites),
                   staged_host_arrays=len(entry._staged),
                   external_vars=len(entry._ext),
                   optimizer_slots=len(entry._binding))
        losses.append(float(step(*staged[1]).numpy().reshape(-1)[0]))
        n = run["timed"]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = None
        for i in range(n):
            last = step(*staged[i % 4])
        losses.append(float(last.numpy().reshape(-1)[0]))   # the one sync
        dt = time.perf_counter() - t0
        flops = transformer_train_flops(run)
        rec.update(timed_steps=n, jit_ms_per_step=dt / n * 1e3,
                   samples_per_s=B * n / dt,
                   target_tokens_per_s=B * n / dt * run["tgt"],
                   train_flop_per_step=flops,
                   tflops=flops / (dt / n) / 1e12)
        if cuda:
            rec["peak_gb_capture_and_replays"] = _peak_from(torch, cuda,
                                                            base)
            rec["device_ms_replay"], rec["launches_replay"] = \
                profiled_launches(torch, lambda: step(*staged[2]))
            rec["idle_share_eager"] = 1 - rec["device_ms_eager"] / \
                rec["eager_ms_per_step_median"]
            rec["idle_share_jit"] = 1 - rec["device_ms_replay"] / \
                rec["jit_ms_per_step"]
        # the gate: a replay from a copied state against an eager step from
        # the same state and tracer key
        state, key = _dy_state(model, opt), tracer._key
        loss_r = step(*staged[3]).value.clone()
        after = _dy_state(model, opt)
        _dy_restore(model, opt, state)
        tracer._key = key
        loss_e = cs.eager(*staged[3]).value
        diff = _dy_bitwise(torch, model, opt, after)
        rec.update(first_loss=losses[0], last_loss=losses[-1],
                   losses=losses,
                   replay_equals_eager_bitwise=bool(
                       torch.equal(loss_r, loss_e)) and not diff,
                   bitwise_diff=diff[:8])
    rec["ok"] = bool(np.isfinite(losses).all()) and \
        rec["replay_equals_eager_bitwise"]
    if opt_kw:
        rec["optimizer_kw"] = {k: type(v).__name__
                               for k, v in opt_kw.items()}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{name} failed: {rec}")
    return rec


# tools/bench_dygraph_ab.py: BERT-base fp32, B64 S128 P20, Adam 1e-4,
# dropout 0.1, a pool of 2 batches; the static side by run_steps
DY_BERT_AB = {"B": 64, "S": 128, "P": 20, "lr": 1e-4, "K": 8,
              "warm_rows": 4, "timed": 20}
DY_BERT_KEYS = ("src_ids", "sent_ids", "pos_ids", "input_mask", "mask_pos",
                "mask_label", "labels")


def dygraph_bert_ab(torch, np, place=None, run=DY_BERT_AB, layers=None,
                    seed=0):
    """tools/bench_dygraph_ab.py on the port: BertPretrainDy by
    ``jit_step`` against the static ``bert_pretrain`` of the same config
    trained by ``Executor.run_steps`` (a slab of K), both fp32 Adam 1e-4
    on one seeded pool: ms/step (host clock), device ms and launches of
    one replay each (a slab / K for the static side), their ratio, and
    the eager dygraph step's ms. Finite losses on both sides."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models import bert, bert_dygraph
    cfg = bert.BertConfig.base()
    if layers is not None:
        cfg.num_layers = layers
    B, S, P, K = run["B"], run["S"], run["P"], run["K"]
    rng = np.random.default_rng(seed)
    pool = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(2)]
    rec = {"phase": "dygraph_bert_ab", **CARD, "B": B, "S": S, "P": P,
           "layers": cfg.num_layers, "dtype": "float32", "K": K}

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        fluid.optimizer.Adam(run["lr"]).minimize(out["loss"])
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    slab = {n: torch.from_numpy(np.stack([pool[i % 2][n]
                                          for i in range(K)])).to(exe.device)
            for n in pool[0]}
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=scope)[0]
    static_losses = [float(x) for x in np.asarray(got).reshape(-1)]
    _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=[out["loss"]], scope=scope))
    rec["static_run_steps_ms_per_step"] = ms / K
    if cuda:
        dms, launches = profiled_launches(torch, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[out["loss"]], scope=scope))
        rec["static_device_ms_per_step"] = dms / K
        rec["static_launches_per_step"] = launches / K
    exe.close()
    del scope, slab

    with dygraph.guard(place):
        dev = dygraph.base._current_tracer().device
        model = bert_dygraph.BertPretrainDy(cfg)
        opt = fluid.optimizer.Adam(run["lr"],
                                   parameter_list=model.parameters())
        step = _dy_step(fluid, dygraph, model, opt)
        staged = [[torch.from_numpy(b[k]).to(dev) for k in DY_BERT_KEYS]
                  for b in pool]
        w = run["warm_rows"]
        small = [t[:w] for t in staged[0]]
        small[4] = staged[0][4][:w * P]
        small[5] = staged[0][5][:w * P]
        dy_losses = [float(step(*small).numpy().reshape(-1)[0])]
        eager_ms = []
        for i in range(3):
            o, ms = _timed_wall(torch, cuda, lambda i=i: step._compiled_step
                                .eager(*staged[i % 2]))
            dy_losses.append(float(o.numpy().reshape(-1)[0]))
            eager_ms.append(ms)
        rec["dygraph_eager_ms_per_step"] = float(np.median(eager_ms[1:]))
        dy_losses.append(float(step(*staged[0]).numpy().reshape(-1)[0]))
        entry = next(iter(step._compiled_step._cache.values()))
        rec["dygraph_capture_s"] = entry.capture_s
        rec["dygraph_graph_pool_gb"] = entry.nbytes / 1e9
        n = run["timed"]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = None
        for i in range(n):
            last = step(*staged[i % 2])
        dy_losses.append(float(last.numpy().reshape(-1)[0]))
        rec["dygraph_jit_ms_per_step"] = (time.perf_counter() - t0) / n * 1e3
        if cuda:
            rec["dygraph_device_ms_per_step"], \
                rec["dygraph_launches_per_step"] = profiled_launches(
                    torch, lambda: step(*staged[1]))
    flops = bert_train_flops_per_sample(cfg, S, P) * B
    rec["train_flop_per_step"] = flops
    rec["static_tflops"] = flops / rec["static_run_steps_ms_per_step"] / 1e9
    rec["dygraph_tflops"] = flops / rec["dygraph_jit_ms_per_step"] / 1e9
    rec["jit_over_static_ms"] = rec["dygraph_jit_ms_per_step"] / \
        rec["static_run_steps_ms_per_step"]
    rec["dygraph_over_static_samples_per_s"] = 1 / rec["jit_over_static_ms"]
    rec.update(static_losses=static_losses, dygraph_losses=dy_losses)
    rec["ok"] = bool(np.isfinite(static_losses + dy_losses).all())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dygraph_bert_ab failed: {rec}")
    return rec


def dygraph_capture_refusals(torch, np, place=None, width=64, seed=9):
    """Nothing hides the device under ``jit_step``: a step that copies
    host data to the device without ``to_variable`` (``h2d``), one that
    reads a value back to the host (``d2h``) and one whose
    ``to_variable`` data change from call to call (``unstaged``) each
    raise ``GraphCaptureError`` at the call that captures (on the CPU,
    where nothing is captured, only ``unstaged`` raises, at the step
    after discovery); the step runs no eager pass instead and leaves
    every parameter and Adam slot as it was."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal((8, width)).astype("float32")
    rec = {"phase": "dygraph_capture_refusals", **CARD}
    with dygraph.guard(place):
        cuda = dygraph.base._current_tracer().device.type == "cuda"
        lin = dygraph.Linear(width, width)
        opt = fluid.optimizer.Adam(1e-3, parameter_list=lin.parameters())
        calls = []

        def make(kind):
            @dygraph.jit_step
            def step(x):
                h = lin(x)
                if kind == "h2d":
                    h = h + dygraph.VarBase(np.ones(width, np.float32))
                if kind == "unstaged":
                    calls.append(1)
                    h = h + dygraph.to_variable(
                        np.full(width, len(calls), np.float32))
                loss = fluid.layers.mean(fluid.layers.square(h))
                if kind == "d2h":
                    loss.numpy()
                loss.backward()
                opt.minimize(loss)
                lin.clear_gradients()
                return loss
            return step

        x = dygraph.to_variable(xv)
        for kind in ("h2d", "d2h", "unstaged"):
            step = make(kind)
            step(x)                                   # the eager warm-up
            state = _dy_state(lin, opt)
            err = None
            try:
                step(x)
            except GraphCaptureError as e:
                # kept as text: the exception's frames hold the entry
                err = {"op_type": e.op_type, "message": str(e)[:160]}
            must = cuda or kind == "unstaged"
            rec[kind] = {
                "raised": err is not None, **(err or {}),
                "state_unchanged": not _dy_bitwise(torch, lin, opt, state),
                "graphs": sum(e.graph is not None
                              for e in step._compiled_step._cache.values())}
            rec[kind]["ok"] = (err is not None) == must and \
                (not must or (rec[kind]["state_unchanged"]
                              and rec[kind]["graphs"] == 0))
    rec["ok"] = all(rec[k]["ok"] for k in ("h2d", "d2h", "unstaged"))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dygraph_capture_refusals: {rec}")
    return rec


# ------------------------------------- control flow and the sequence models

# PaddlePaddle/models PaddleNLP/seq2seq/seq2seq (run.sh / infer.sh):
# IWSLT'15 English->Vietnamese, hidden 512, embedding 512, vocabularies
# 17191 / 7709, batch 128, sentences up to 50 tokens, Adam 1e-3, beam 10
SEQ2SEQ = {"src_vocab": 17191, "tgt_vocab": 7709, "emb": 512, "hidden": 512,
           "T_src": 50, "T_tgt": 50, "B": 128, "lr": 1e-3, "beam": 10,
           "max_len": 50, "sentences": 4}
# the book's sequence models at the seq2seq widths
SEQ_BOOK = {"E": 512, "H": 512, "B": 128, "T": 50, "vocab": 7709,
            "lr": 1e-3}
# tests/test_control_flow.py's Switch schedule: (step, the lr the JAX
# package's run gives, as float32), held to the JAX package on the CPU by
# tests/test_torch_control_flow.py
SWITCH_LR_SCHEDULE = ((50.0, 0.10000000149011612),
                      (500.0, 0.009999999776482582),
                      (5000.0, 0.0010000000474974513))
BOS, EOS = 1, 2


def seq2seq_program(cfg, decode=False):
    """models.seq2seq's training program (+ ``Adam(lr)``) or its beam
    decode program at ``cfg``'s widths. Returns (main, startup,
    outputs)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import seq2seq
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 8
    widths = (cfg["src_vocab"], cfg["tgt_vocab"], cfg["emb"], cfg["hidden"],
              cfg["T_src"])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if decode:
            out = seq2seq.seq2seq_beam_decode(
                *widths, max_len=cfg["max_len"], beam_size=cfg["beam"],
                bos_id=BOS, eos_id=EOS)
        else:
            out = seq2seq.seq2seq_train(*widths, cfg["T_tgt"], cfg["B"])
            fluid.optimizer.Adam(cfg["lr"]).minimize(out["loss"])
    return main, startup, out


def seq2seq_batch(torch, np, cfg, device, seed=0):
    """One seeded batch on ``device``: src [T_src, B], tgt_in [T_tgt, B]
    (BOS first) and tgt_out (shifted, EOS last), ids past BOS/EOS."""
    rng = np.random.default_rng(seed)
    B, T = cfg["B"], cfg["T_tgt"]
    src = rng.integers(3, cfg["src_vocab"], (cfg["T_src"], B))
    tgt = rng.integers(3, cfg["tgt_vocab"], (T - 1, B))
    tin = np.vstack([np.full((1, B), BOS), tgt])
    tout = np.vstack([tgt, np.full((1, B), EOS)])
    return {n: torch.from_numpy(a.astype(np.int64)).to(device)
            for n, a in (("src", src), ("tgt_in", tin), ("tgt_out", tout))}


def _op_annotations(torch, label):
    """Patch the interpreter so each top-level op runs under the
    ``torch.profiler.record_function`` range ``label(op)`` names (none
    where it gives None; :func:`_op_label`). Returns the undo."""
    from paddle_tpu_torch.framework import lowering
    plain = lowering.run_op

    def run_op(ctx, op):
        name = label(op) if ctx.block.idx == 0 else None
        if name is not None:
            with torch.profiler.record_function(name):
                return plain(ctx, op)
        return plain(ctx, op)

    lowering.run_op = run_op
    return lambda: setattr(lowering, "run_op", plain)


def _op_label(types=(), marked=None):
    """A label for :func:`_op_annotations`: ``op::<type>`` for ``types``,
    then ``name`` for an op whose first output one of ``marked``'s
    ``_OpsOf`` ({name: _OpsOf}) recorded."""
    def label(op):
        if op.type in types:
            return f"op::{op.type}"
        outs = op.output_arg_names
        for name, rec in (marked or {}).items():
            if outs and outs[0] in rec.names:
                return name
        return None
    return label


def _range_device_ms(torch, fn, names):
    """(device ms of one call of ``fn``, {name: device ms of the kernels
    launched inside the ``record_function`` range ``name``}) from
    torch.profiler. A kernel belongs to the range whose host-side span
    holds the start of the op that launched it, on any thread: the
    backward kernels that autograd launches from its own thread while
    the range waits for them count, and an eager range's idle gaps on
    the device do not."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    total = sum(float(e.cuda_time if getattr(e, "device_time", None) is None
                      else e.device_time)
                for e in events if e.device_type == cuda
                and e.name not in names)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in events if e.device_type != cuda and e.name in names]
    ranges = dict.fromkeys(names, 0.0)
    ranges["all launching ops"] = 0.0      # holds the attribution to total
    for e in events:
        if e.device_type == cuda or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        ranges["all launching ops"] += ms
        for name, a, b in spans:
            if a <= e.time_range.start < b:
                ranges[name] += ms
                break
    return total / 1e3, {n: (v if spans else None)
                         for n, v in ranges.items()}


def seq2seq_train(torch, np, place=None, cfg=SEQ2SEQ, K=8, eager_timed=4):
    """The slice's main path: the GRU seq2seq at IWSLT'15 en-vi widths
    (``SEQ2SEQ``) trained by ``Executor.run`` and by ``run_steps``, fp32,
    from copies of one seeded startup, on one seeded batch repeated:

    - K eager steps against one ``run_steps`` slab of K (one captured
      CUDA graph per step): losses, every parameter and Adam slot
      bitwise; every loss finite; the loss falls over the slab;
    - the first ``eager_timed`` eager steps' wall ms, a second slab's ms
      a step; device ms a step both ways (torch.profiler), kernel
      launches per eager step and per replay, idle shares, the capture
      seconds (first slab less its replays), the graph pool's bytes, the
      peak memory over the eager steps and over the first slab, target
      tokens/s (B x T_tgt a step);
    - the share of an eager step's device time in the two ``recurrent``
      ops and in their ``recurrent_grad`` ops (the generic vjp recomputes
      the whole recurrence: its recompute is one ``recurrent`` forward
      again).

    Returns (record, the trained scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    main, startup, out = seq2seq_program(cfg)
    loss = out["loss"]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    feed = seq2seq_batch(torch, np, cfg, exe.device)
    slab = {n: torch.stack([t] * K) for n, t in feed.items()}
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    del scope0
    failures = []
    base = _peak_base(torch, cuda)
    eager, wall = [], []
    for _ in range(K):
        l, ms = _timed_wall(torch, cuda, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=sA)[0])
        eager.append(l)
        wall.append(ms)
    peak_eager = _peak_from(torch, cuda, base)
    base = _peak_base(torch, cuda)
    try:
        got, first_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=sB)[0])
    except GraphCaptureError as e:
        raise AssertionError(f"seq2seq_train: the step did not capture: "
                             f"{e}") from e
    peak_slab = _peak_from(torch, cuda, base)
    diff = scope_diff(torch, sA, sB)
    tokens = cfg["B"] * cfg["T_tgt"]
    rec = {"phase": "seq2seq_train", **CARD,
           **{k: cfg[k] for k in ("src_vocab", "tgt_vocab", "emb", "hidden",
                                  "T_src", "T_tgt", "B")},
           "optimizer": f"Adam({cfg['lr']})", "dtype": "float32", "K": K,
           "eager_losses": [float(x) for x in eager],
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
           "scope_bitwise": not diff, "scope_diff": diff[:8],
           "ops_as_built": len(main.global_block().ops),
           "eager_ms_per_step": wall[:eager_timed],
           "eager_ms_per_step_median": float(np.median(wall[1:eager_timed])),
           "first_slab_s": first_ms / 1e3,
           "peak_gb_eager": peak_eager, "peak_gb_over_first_slab": peak_slab}
    _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=[loss], scope=sB))
    rec["run_steps_ms_per_step"] = ms / K
    rec["capture_s"] = (first_ms - ms) / 1e3
    rec["target_tokens_per_s_eager"] = \
        tokens / rec["eager_ms_per_step_median"] * 1e3
    rec["target_tokens_per_s_run_steps"] = \
        tokens / rec["run_steps_ms_per_step"] * 1e3
    if cuda:
        ms, n = profiled_launches(torch, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=sB))
        rec["device_ms_per_step_run_steps"] = ms / K
        rec["launches_per_replay"] = n / K
        undo = _op_annotations(torch, _op_label(("recurrent",
                                                 "recurrent_grad")))
        try:
            dev, ranges = _range_device_ms(torch, lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=sA),
                ("op::recurrent", "op::recurrent_grad"))
        finally:
            undo()
        rec["device_ms_per_step_eager"] = dev
        rec["launches_per_eager_step"] = profiled_launches(
            torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=sA))[1]
        fwd, grad = ranges.get("op::recurrent"), \
            ranges.get("op::recurrent_grad")
        rec["device_ms_by_launching_op"] = ranges.get("all launching ops")
        rec["recurrent_device_ms"] = fwd
        rec["recurrent_grad_device_ms"] = grad
        # the grad's recompute is the forward recurrence run again
        rec["recompute_share_of_device_ms"] = \
            None if fwd is None else fwd / dev
        rec["recurrent_grad_share_of_device_ms"] = \
            None if grad is None else grad / dev
        rec["idle_share_eager"] = 1 - dev / rec["eager_ms_per_step_median"]
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["graph_pool_gb"] = _captured(exe).nbytes / 1e9
    losses = rec["eager_losses"]
    if not (rec["losses_bitwise"] and not diff):
        failures.append(f"run_steps is not its eager steps: scope diff "
                        f"{diff[:8]}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(
            rec["run_steps_losses"]))):
        failures.append(f"non-finite losses {losses}")
    if not rec["run_steps_losses"][-1] < rec["run_steps_losses"][0]:
        failures.append(f"the loss did not fall over the slab: "
                        f"{rec['run_steps_losses']}")
    rec["ok"] = not failures
    exe.close()
    del sA
    emit(rec)
    if failures:
        raise AssertionError(f"seq2seq_train: {failures}")
    return rec, sB


def seq2seq_decode(torch, np, scope, place=None, cfg=SEQ2SEQ, seed=21):
    """Beam decode (``cfg["beam"]`` beams, ``cfg["max_len"]`` steps) of
    ``cfg["sentences"]`` seeded source sentences over the trained
    ``scope``: eagerly (``Executor.run``), as a ``CapturedProgram``
    replay (the sequences and scores bitwise the eager run's), then saved
    with ``io.save_inference_model`` (pruned through the encoder's
    ``recurrent`` sub-block) and run by ``AnalysisPredictor`` from the
    directory (the sequences equal the executor's). Prints ms a sentence
    eager and by replay; no kernel of the port launches."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.framework.cuda_graph import CapturedProgram
    main, _, dec = seq2seq_program(cfg, decode=True)
    fetch = [dec["sequences"].name, dec["scores"].name]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rng = np.random.default_rng(seed)
    feeds = [{"src": rng.integers(3, cfg["src_vocab"], (cfg["T_src"], 1))
              .astype(np.int64)} for _ in range(cfg["sentences"])]
    eager, wall = [], []
    for f in feeds:
        o, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
            main, feed=f, fetch_list=fetch, scope=scope))
        eager.append(o)
        wall.append(ms)
    entry = CapturedProgram(passes.optimize_program(main, fetch), feeds[0],
                            fetch, scope, exe.device)
    replay, rwall = [], []
    for f in feeds:
        o, ms = _timed_wall(torch, cuda, lambda f=f: entry.run(f))
        replay.append(o)
        rwall.append(ms)
    bitwise = all(np.array_equal(a, b) for e, r in zip(eager, replay)
                  for a, b in zip(e, r))
    d = os.path.join(SERVE_DIR, "seq2seq_decode")
    shutil.rmtree(d, ignore_errors=True)
    fluid.save_inference_model(d, ["src"], [dec["sequences"],
                                            dec["scores"]], exe,
                               main_program=main, scope=scope)
    icfg = inference.AnalysisConfig(d)
    if not cuda:
        icfg.disable_gpu()
    pred = inference.create_predictor(icfg)
    served = [pred.run([f["src"]]) for f in feeds]
    pred_equal = all(np.array_equal(s[0], e[0])
                     for s, e in zip(served, eager))
    seqs = np.stack([e[0] for e in eager])      # [n, T, 1, beam]
    rec = {"phase": "seq2seq_decode", **CARD, "beam": cfg["beam"],
           "max_len": cfg["max_len"], "sentences": len(feeds),
           "eager_ms_per_sentence": wall,
           "eager_ms_per_sentence_median": float(np.median(wall[1:])),
           "replay_ms_per_sentence": rwall,
           "replay_ms_per_sentence_median": float(np.median(rwall[1:])),
           "graph_bytes": entry.nbytes, "replay_bitwise_eager": bitwise,
           "predictor_equals_executor": pred_equal,
           "saved_ops": len(pred.program().global_block().ops),
           "best_beam_first_tokens": seqs[:, :4, 0, 0].tolist(),
           "ids_in_vocab": bool(((seqs >= 0)
                                 & (seqs < cfg["tgt_vocab"])).all())}
    rec["ok"] = bitwise and pred_equal and rec["ids_in_vocab"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"seq2seq_decode: {rec}")
    return rec


def _steps_vs_slab(torch, np, fluid, exe, main, startup, fetch, feed, K):
    """K eager ``run`` steps and one ``run_steps`` slab of K on ``feed``
    from copies of one startup: (eager fetches, slab fetches, each
    stacked [K, ...] per fetch, names whose final values differ)."""
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    eager = [exe.run(main, feed=feed, fetch_list=fetch, scope=sA)
             for _ in range(K)]
    slab = {n: np.stack([a] * K) for n, a in feed.items()}
    got = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=sB)
    return ([np.stack([e[i] for e in eager]) for i in range(len(fetch))],
            got, scope_diff(torch, sA, sB))


def _refused(torch, np, fluid, exe, main, startup, fetch, feed, K=2):
    """``run_steps`` of a program whose op needs the host: the
    ``GraphCaptureError`` (op type, message) or None, and whether the
    scope came out unchanged."""
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)   # eager: fine
    before = copied_scope(torch, fluid, scope)
    slab = {n: np.stack([a] * K) for n, a in feed.items()}
    err = None
    try:
        exe.run_steps(main, feed=slab, fetch_list=fetch, scope=scope)
    except GraphCaptureError as e:
        err = {"op_type": e.op_type, "message": str(e)[:200]}
    return err, not scope_diff(torch, before, scope)


def control_flow(torch, np, place=None, K=4):
    """Small programs through the sub-block ops on the card:

    - a bounded ``While`` (``max_trip_count``) whose body scales a
      trained parameter, with its grad: a ``run_steps`` slab of K is
      bitwise K eager steps;
    - a dropout inside a ``StaticRNN`` step of a training step: the slab
      bitwise the eager steps, one mask for every step of a run (as the
      JAX package's scan body draws), a new one each run;
    - an unbounded ``While`` (a data-dependent trip count): ``run``
      gives the count a numpy loop gives, twice;
    - an unbounded ``While`` and a ``cond`` in a training step: on the
      card ``run_steps`` raises ``GraphCaptureError`` naming the op at
      the capturing call and leaves the scope as it was (on the CPU,
      where nothing is captured, the slab runs);
    - the ``Switch`` LR schedule of tests/test_control_flow.py: ``run``
      gives the JAX package's values (``SWITCH_LR_SCHEDULE``) exactly."""
    import paddle_tpu_torch as fluid
    L = fluid.layers
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rec = {"phase": "control_flow", **CARD}
    rng = np.random.default_rng(31)
    xv = rng.standard_normal((8, 16)).astype(np.float32)

    def program(body):
        """x -> tanh fc -> ``body(x, h)`` -> (objective or None, extra
        fetch); Adam on the objective (mean(h^2) when None)."""
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = L.data("x", [8, 16], dtype="float32")
            h = L.fc(x, 16, act="tanh")
            loss, extra = body(x, h)
            if loss is None:
                loss = L.mean(L.square(h))
            fluid.optimizer.Adam(1e-2).minimize(loss)
        return main, startup, loss, extra

    def bounded(x, h):
        w = L.create_parameter([16], "float32", name="cf.w")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.assign(h)
        cond_v = L.less_than(i, n)
        loop = L.While(cond_v, max_trip_count=6)
        with loop.block():
            L.assign(L.elementwise_mul(acc, w), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
        return L.mean(L.square(acc)), None

    main, startup, loss, _ = program(bounded)
    (eager,), (got,), diff = _steps_vs_slab(
        torch, np, fluid, exe, main, startup, [loss], {"x": xv}, K)
    rec["bounded_while"] = {"losses": got.tolist(),
                            "bitwise": bool(np.array_equal(eager, got))
                            and not diff, "scope_diff": diff[:8]}

    def step_dropout(x, h):
        steps = L.reshape(h, [4, 2, 16])
        rnn = L.StaticRNN()
        with rnn.step():
            rnn.step_output(L.dropout(rnn.step_input(steps), 0.5))
        seq = rnn()
        return L.mean(L.square(seq)), seq

    # a dropout in a step body draws one mask for every step of a run, in
    # a replay as eagerly (each call site its own registered generator)
    main, startup, loss, seq = program(step_dropout)
    eager, got, diff = _steps_vs_slab(torch, np, fluid, exe, main, startup,
                                      [loss, seq], {"x": xv}, K)
    masks = got[1] != 0                            # [K, T, 2, 16]
    rec["dropout_in_step_body"] = {
        "bitwise": all(np.array_equal(a, b) for a, b in zip(eager, got))
        and not diff, "scope_diff": diff[:8],
        "one_mask_per_run": bool((masks == masks[:, :1]).all()),
        "masks_differ_run_to_run": bool((masks[1:] != masks[:1]).any())}

    def count(x, h):
        i = L.fill_constant([1], "int64", 0)
        acc = L.reduce_sum(L.square(x))
        limit = L.fill_constant([1], "float32", 1e6)
        cond_v = L.less_than(acc, limit)
        loop = L.While(cond_v)
        with loop.block():
            L.assign(L.scale(acc, 3.0), acc)
            L.increment(i, value=1)
            L.less_than(acc, limit, cond=cond_v)
        return None, [i, acc]

    main, startup, loss, (i, acc) = program(count)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    runs = [int(exe.run(main, feed={"x": xv}, fetch_list=[i],
                        scope=scope)[0][0]) for _ in range(2)]
    a, want = np.sum(np.square(xv), dtype=np.float32), 0
    while a < np.float32(1e6):
        a, want = np.float32(a * np.float32(3.0)), want + 1
    rec["unbounded_while"] = {"trips": runs, "numpy_trips": want,
                              "ok": runs == [want, want]}
    err, same = _refused(torch, np, fluid, exe, main, startup, [loss, i],
                         {"x": xv})
    rec["unbounded_while_capture"] = {"raised": err, "scope_unchanged": same}

    def branch(x, h):
        pred = L.greater_than(L.reduce_sum(x),
                              L.fill_constant([1], "float32", 0.0))
        return None, L.cond(pred, lambda: L.scale(L.reduce_sum(h), 2.0),
                            lambda: L.scale(L.reduce_sum(h), -1.0))

    main, startup, loss, out = program(branch)
    err2, same2 = _refused(torch, np, fluid, exe, main, startup,
                           [loss, out], {"x": xv})
    rec["cond_capture"] = {"raised": err2, "scope_unchanged": same2}
    for key, e, s, op in (("unbounded_while_capture", err, same, "while"),
                          ("cond_capture", err2, same2, "cond")):
        # on the CPU nothing is captured: the slab runs and trains
        rec[key]["ok"] = (e is not None and e["op_type"] == op and s) \
            if cuda else (e is None and not s)

    sched = []
    for step, want in SWITCH_LR_SCHEDULE:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            st = L.data("step", [1], dtype="float32")
            lr = L.fill_constant([1], "float32", 0.0)
            b1 = L.fill_constant([1], "float32", 100.0)
            b2 = L.fill_constant([1], "float32", 1000.0)
            with L.Switch() as switch:
                with switch.case(L.less_than(st, b1)):
                    L.assign(L.fill_constant([1], "float32", 0.1), lr)
                with switch.case(L.less_than(st, b2)):
                    L.assign(L.fill_constant([1], "float32", 0.01), lr)
                with switch.default():
                    L.assign(L.fill_constant([1], "float32", 0.001), lr)
        got = exe.run(main, feed={"step": np.array([step], np.float32)},
                      fetch_list=[lr])[0]
        sched.append((step, float(got[0]), float(got[0]) == want))
    rec["switch_lr"] = sched
    rec["ok"] = rec["bounded_while"]["bitwise"] and \
        all(rec["dropout_in_step_body"][k] for k in (
            "bitwise", "one_mask_per_run", "masks_differ_run_to_run")) and \
        rec["unbounded_while"]["ok"] and \
        rec["unbounded_while_capture"]["ok"] and rec["cond_capture"]["ok"] \
        and all(ok for _, _, ok in sched)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"control_flow: {rec}")
    return rec


def sequence_lstm(torch, np, place=None, cfg=SEQ_BOOK, K=4, seed=41):
    """tests/test_book.py's sentiment LSTM (embedding, a projection, the
    full-sequence ``lstm`` op, ``sequence_pool`` "last" by length, a
    2-way classifier) and its ``dynamic_gru`` encoder-decoder (teacher
    forced, a ``vocab``-way output), at ``SEQ_BOOK``'s widths with
    seeded lengths, Adam(lr): K eager steps and one ``run_steps`` slab of
    K from copies of one startup, bitwise each other, the losses
    falling; wall ms a step both ways."""
    import paddle_tpu_torch as fluid
    L = fluid.layers
    E, H, B, T, V = (cfg[k] for k in ("E", "H", "B", "T", "vocab"))
    rng = np.random.default_rng(seed)
    words = rng.integers(1, V, (B, T)).astype(np.int64)
    tgt = rng.integers(1, V, (B, T)).astype(np.int64)
    feeds = {
        "sentiment": {"words": words,
                      "lens": rng.integers(T // 4, T + 1, (B,)).astype(
                          np.int64),
                      "label": (words[:, 0] % 2).astype(np.int64)[:, None]},
        "encoder_decoder": {"s": words, "ti": tgt,
                            "to": np.roll(tgt, -1, axis=1)}}

    def sentiment():
        w = L.data("words", [B, T], dtype="int64")
        ln = L.data("lens", [B], dtype="int64")
        y = L.data("label", [B, 1], dtype="int64")
        hidden, _ = L.dynamic_lstm(
            L.fc(L.embedding(w, size=[V, E]), 4 * H, num_flatten_dims=2),
            4 * H, use_peepholes=False, length=ln)
        last = L.sequence_pool(hidden, "last", length=ln)
        return L.mean(L.softmax_with_cross_entropy(L.fc(last, 2), y))

    def encoder_decoder():
        s = L.data("s", [B, T], dtype="int64")
        ti = L.data("ti", [B, T], dtype="int64")
        to = L.data("to", [B, T], dtype="int64")
        enc = L.dynamic_gru(L.fc(L.embedding(s, size=[V, E]), 3 * H,
                                 num_flatten_dims=2), H)
        enc_last = L.sequence_last_step(
            enc, length=L.fill_constant([B], "int64", T))
        dec = L.dynamic_gru(L.fc(L.embedding(ti, size=[V, E]), 3 * H,
                                 num_flatten_dims=2), H, h_0=enc_last)
        return L.mean(L.softmax_with_cross_entropy(
            L.fc(dec, V, num_flatten_dims=2), L.unsqueeze(to, [2])))

    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rec = {"phase": "sequence_lstm", **CARD, **cfg, "K": K}
    for name, build in (("sentiment", sentiment),
                        ("encoder_decoder", encoder_decoder)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 11
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = build()
            fluid.optimizer.Adam(cfg["lr"]).minimize(loss)
        ((eager,), (got,), diff), ms = _timed_wall(torch, cuda, lambda: (
            _steps_vs_slab(torch, np, fluid, exe, main, startup, [loss],
                           feeds[name], K)))
        r = {"eager_losses": eager.tolist(), "run_steps_losses": got.tolist(),
             "bitwise": bool(np.array_equal(eager, got)) and not diff,
             "scope_diff": diff[:8], "both_ways_s": ms / 1e3}
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feeds[name], fetch_list=[loss], scope=scope)
        _, r["eager_ms_per_step"] = _timed_wall(torch, cuda, lambda: exe.run(
            main, feed=feeds[name], fetch_list=[loss], scope=scope))
        slab = {n: np.stack([a] * K) for n, a in feeds[name].items()}
        _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=scope))
        r["run_steps_ms_per_step"] = ms / K
        r["ok"] = r["bitwise"] and bool(np.isfinite(got).all()) and \
            bool(got[-1] < got[0])
        rec[name] = r
        exe.close()
    rec["ok"] = rec["sentiment"]["ok"] and rec["encoder_decoder"]["ok"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"sequence_lstm: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the optimizer stack and exact training resume
# ---------------------------------------------------------------------------

# the LAMB paper's BERT recipe (You et al., ICLR 2020): beta1 0.9, beta2
# 0.999, epsilon 1e-6, weight decay 0.01, a linear warm-up into a
# polynomial decay, global-norm clipping at 1.0; the warm-up is cut to 4
# steps so that 8 steps see the rate rise and the loss fall
# the depths these BERT-base paths train at in the one-card run, where
# 12 layers each left the script no room inside its time limit (each
# path's checks scale with its layers; BERT-base's width, batch and
# sequence stay; fleet_bert's on one card only, so a four-card run's
# scaling line compares like with like)
ONE_CARD_LAYERS = {"supervised_bert": 2, "fleet_bert": 2,
                   "dygraph_bert_ab": 4, "flagship_steps": 4}
LAMB_BERT = {"peak_lr": 1e-3, "warmup_steps": 4, "decay_steps": 1000,
             "end_lr": 0.0, "power": 1.0, "weight_decay": 0.01,
             "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "clip_norm": 1.0}
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")


class _OpsOf:
    """Wraps a clip or regularizer: calls it, and keeps in ``names`` the
    outputs of the ops it appends to the main program (how a profiled
    step finds those ops again in the program the executor runs)."""

    def __init__(self, fn):
        self.fn, self.names = fn, set()

    def __call__(self, *args):
        from paddle_tpu_torch.framework.core import default_main_program
        block = default_main_program().global_block()
        first = len(block.ops)
        out = self.fn(*args)
        self.names.update(n for op in block.ops[first:]
                          for n in op.output_arg_names)
        return out

    def __getattr__(self, item):
        return getattr(self.fn, item)


def build_bert_lamb(cfg, B, S, P, optimizer="lamb", recipe=LAMB_BERT):
    """BERT pretraining as bench_bert_long builds it (``bert_pretrain``,
    bf16 AMP through ``mp.decorate`` at a static loss scale of 1.0) at
    ``linear_lr_warmup(polynomial_decay(...))``, under
    ``LambOptimizer(...)`` with ``GradientClipByGlobalNorm`` (the
    recipe), or ``AdamOptimizer`` at the same rate without a clip.
    Returns (main, startup, outputs, lr var, the clip's ``_OpsOf``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    r = recipe
    clip = None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(r["peak_lr"], r["decay_steps"],
                                          r["end_lr"], power=r["power"]),
            r["warmup_steps"], 0.0, r["peak_lr"])
        if optimizer == "lamb":
            clip = _OpsOf(fluid.clip.GradientClipByGlobalNorm(
                r["clip_norm"]))
            opt = fluid.optimizer.LambOptimizer(
                lr, lamb_weight_decay=r["weight_decay"], beta1=r["beta1"],
                beta2=r["beta2"], epsilon=r["epsilon"], grad_clip=clip)
        else:
            opt = fluid.optimizer.AdamOptimizer(lr)
        mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(),
                    init_loss_scaling=1.0,
                    use_dynamic_loss_scaling=False).minimize(out["loss"])
    return main, startup, out, lr, clip


def _release(torch, exe):
    """Close ``exe`` and free its captured graphs' pools now (a captured
    step is freed by the cycle collector), so the next capture of a
    path does not sit beside them."""
    exe.close()
    gc.collect()
    if exe.device.type == "cuda":
        torch.cuda.empty_cache()


def _manifest_files(path):
    with open(os.path.join(path, "_manifest.json")) as f:
        return json.load(f)["files"]


def bert_lamb(torch, np, fa, place=None, layers=None, B=16, S=2048, P=64,
              K=4, seed=15):
    """The slice's main path: BERT-base at bench_bert_long's shape (B16
    S2048 P64, flash attention, bf16 AMP, dropout 0.1, no recompute)
    under the LAMB recipe (``LAMB_BERT``) with global-norm clipping, on
    one seeded batch repeated, from one seeded startup:

    - K eager ``Executor.run`` steps against a ``run_steps`` slab of K
      from copies of that scope: losses, the LR and the whole scope
      (params, both moments, both beta-pows, the LR counter, the run
      seed) bitwise; K1 and K2 once per layer a step, eager and per
      replay;
    - ``TrainCheckpoint.save`` after slab 1, synchronous, then with
      ``async_save=True`` while slab 2 runs; the background checkpoint's
      files equal the synchronous one's (its snapshot predates slab 2);
      a fresh ``Executor`` and ``Scope``, ``restore_latest`` and slab 2:
      losses and whole scope bitwise the uninterrupted run's; the loss
      falls over the 2K steps;
    - wall ms a step by ``run_steps`` (a third slab) and eagerly, device
      ms (torch.profiler), idle shares, tokens/s, TFLOP/s (bench.py's
      FLOP count), kernels per replay, the device ms of the ``lamb`` ops
      and of the clip's ops in an eager step; the same program under
      ``AdamOptimizer`` without a clip, measured the same way in this
      run; checkpoint bytes, the synchronous save's seconds, the
      background save's host gather and its seconds to ``wait``,
      ``restore_latest``'s seconds, the peak memory."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.executor import RNG_STATE_NAME
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    k1, k2 = fa.flash_attention_fwd, fa.flash_attention_bwd_single
    L = cfg.num_layers
    feed = {n: torch.from_numpy(a).to(exe.device) for n, a in
            bert.random_batch(cfg, B, S, P,
                              rng=np.random.default_rng(seed)).items()}
    slab = {n: torch.stack([t] * K) for n, t in feed.items()}
    rec = {"phase": "bert_lamb", **CARD, "B": B, "S": S, "P": P, "K": K,
           "layers": L, "hidden": cfg.hidden_size, "attention": "flash",
           "amp": "bf16", "dropout": cfg.hidden_dropout,
           "recompute": False, "recipe": LAMB_BERT}
    failures = []
    base = _peak_base(torch, cuda)
    main, startup, out, lr, clip = build_bert_lamb(cfg, B, S, P)
    fetch = [out["loss"], lr]
    types = [op.type for op in main.global_block().ops]
    rec["lamb_ops"] = types.count("lamb")
    rec["clip_ops"] = {t: sum(op.type == t and op.output_arg_names[0]
                              in clip.names
                              for op in main.global_block().ops)
                       for t in sorted({op.type for op in
                                        main.global_block().ops
                                        if op.output_arg_names and
                                        op.output_arg_names[0]
                                        in clip.names})}
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    del scope0
    # (a) K eager steps against the first slab
    before = (k1.launches, k2.launches)
    eager, wall = [], []
    for _ in range(K):
        r, ms = _timed_wall(torch, cuda, lambda: exe.run(
            main, feed=feed, fetch_list=fetch, scope=sA))
        eager.append(r)
        wall.append(ms)
    rec["k1_k2_per_eager_step"] = ((k1.launches - before[0]) / K,
                                   (k2.launches - before[1]) / K)
    before = (k1.launches, k2.launches)
    got1, first_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=fetch, scope=sB))
    warm = {w.__name__: n for (w, a), n in
            _captured(exe).warmup_launches.items() if a == "launches"}
    rec["k1_k2_per_replay"] = (
        (k1.launches - before[0] - warm.get(k1.__name__, 0)) / K,
        (k2.launches - before[1] - warm.get(k2.__name__, 0)) / K)
    rec["first_slab_s"] = first_ms / 1e3
    rec["eager_ms_per_step"] = wall
    rec["eager_losses"] = [float(e[0]) for e in eager]
    rec["slab1_losses"] = [float(x) for x in got1[0]]
    rec["lr"] = [float(x) for x in np.ravel(got1[1])]
    diff = scope_diff(torch, sA, sB)
    rec["slab1_bitwise_eager"] = bool(
        np.array_equal(got1[0], np.stack([e[0] for e in eager])) and
        np.array_equal(got1[1], np.stack([e[1] for e in eager]))) \
        and not diff
    rec["slab1_scope_diff"] = diff[:8]
    if not rec["slab1_bitwise_eager"]:
        failures.append(f"the first slab is not its eager steps: "
                        f"{rec['slab1_losses']} vs {rec['eager_losses']}, "
                        f"scope diff {diff[:8]}")
    if cuda and (rec["k1_k2_per_eager_step"] != (L, L) or
                 rec["k1_k2_per_replay"] != (L, L)):
        failures.append(f"K1/K2 a step {rec['k1_k2_per_eager_step']}, a "
                        f"replay {rec['k1_k2_per_replay']}, not {(L, L)}")
    # (b) checkpoints after slab 1: synchronous, then in the background
    # while slab 2 runs
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ck = fluid.train.TrainCheckpoint(CKPT_DIR, max_to_keep=2)
    _sync(torch, exe)
    t0 = time.perf_counter()
    ck.save(exe, program=main, scope=sB, train_state={"slab": 1})
    rec["sync_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    no = ck.save(exe, program=main, scope=sB, train_state={"slab": 1},
                 async_save=True)
    rec["async_host_gather_s"] = time.perf_counter() - t0
    got2, rec["slab2_ms_beside_async_write"] = _timed_wall(
        torch, cuda, lambda: exe.run_steps(main, feed=slab,
                                           fetch_list=fetch, scope=sB))
    ck.wait()
    rec["async_save_to_wait_s"] = time.perf_counter() - t0
    paths = [ck.saver._path(n) for n in (no - 1, no)]
    rec["checkpoint_bytes"] = dir_bytes(paths[1])
    rec["checkpoint_files"] = len(os.listdir(paths[1]))
    rec["async_equals_sync_checkpoint"] = \
        _manifest_files(paths[0]) == _manifest_files(paths[1])
    if not rec["async_equals_sync_checkpoint"]:
        failures.append("the background checkpoint is not the synchronous "
                        "one: its snapshot saw slab 2")
    _release(torch, exe)
    # (c) a fresh executor and scope resume from the newest checkpoint
    exe2, sC = fluid.Executor(place), fluid.Scope()
    _sync(torch, exe2)
    t0 = time.perf_counter()
    restored = ck.restore_latest(exe2, program=main, scope=sC)
    _sync(torch, exe2)
    rec["restore_s"] = time.perf_counter() - t0
    rec["restored"] = list(restored)
    got3 = exe2.run_steps(main, feed=slab, fetch_list=fetch, scope=sC)
    diff = scope_diff(torch, sB, sC)
    rec["slab2_losses"] = [float(x) for x in got2[0]]
    rec["resumed_slab2_losses"] = [float(x) for x in got3[0]]
    rec["resume_bitwise"] = bool(np.array_equal(got2[0], got3[0]) and
                                 np.array_equal(got2[1], got3[1])) \
        and not diff
    rec["resume_scope_diff"] = diff[:8]
    rec["run_seed_restored"] = sB.find_var(RNG_STATE_NAME) == \
        sC.find_var(RNG_STATE_NAME)
    if restored[0] != no or not rec["resume_bitwise"]:
        failures.append(f"the resume from checkpoint {restored} is not "
                        f"the uninterrupted run: {rec['slab2_losses']} vs "
                        f"{rec['resumed_slab2_losses']}, diff {diff[:8]}")
    losses = rec["slab1_losses"] + rec["slab2_losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        failures.append(f"the loss did not fall: {losses}")
    del sB
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    # (d) timing: a third slab, the profiles
    _, ms = _timed_wall(torch, cuda, lambda: exe2.run_steps(
        main, feed=slab, fetch_list=fetch, scope=sC))
    rec["run_steps_ms_per_step"] = ms / K
    rec["eager_ms_per_step_median"] = float(np.median(wall[1:]))
    flops = bert_train_flops_per_sample(cfg, S, P) * B
    rec["analytic_flops_per_step"] = flops
    rec["tokens_per_s_run_steps"] = B * S / rec["run_steps_ms_per_step"] \
        * 1e3
    rec["tflops_run_steps"] = flops / rec["run_steps_ms_per_step"] / 1e9
    if cuda:
        dev, n = profiled_launches(torch, lambda: exe2.run_steps(
            main, feed=slab, fetch_list=fetch, scope=sC))
        rec["device_ms_per_step_run_steps"] = dev / K
        rec["kernels_per_replay"] = n / K
        rec["graph_pool_gb"] = _captured(exe2).nbytes / 1e9
        undo = _op_annotations(torch, _op_label(("lamb",), {"clip": clip}))
        try:
            dev, ranges = _range_device_ms(torch, lambda: exe2.run(
                main, feed=feed, fetch_list=fetch, scope=sA),
                ("op::lamb", "clip"))
        finally:
            undo()
        rec["device_ms_per_step_eager"] = dev
        rec["lamb_ops_device_ms"] = ranges.get("op::lamb")
        rec["clip_ops_device_ms"] = ranges.get("clip")
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["idle_share_eager"] = 1 - dev / rec["eager_ms_per_step_median"]
        rec["peak_gb"] = _peak_from(torch, cuda, base)
    del sA, sC
    _release(torch, exe2)
    # (e) the same program under Adam without a clip, in this run
    rec["adam"] = _bert_adam_ab(torch, np, fluid, place, cfg, B, S, P, K,
                                feed, slab)
    if cuda:
        a = rec["adam"]
        rec["lamb_clip_minus_adam_ms_per_step"] = \
            rec["run_steps_ms_per_step"] - a["run_steps_ms_per_step"]
        rec["lamb_clip_minus_adam_device_ms_per_step"] = \
            rec["device_ms_per_step_run_steps"] - \
            a["device_ms_per_step_run_steps"]
    rec["ok"] = not failures
    emit(rec)
    if failures:
        raise AssertionError(f"bert_lamb: {failures}")
    return rec


def _bert_adam_ab(torch, np, fluid, place, cfg, B, S, P, K, feed, slab):
    """bert_lamb's program under ``AdamOptimizer`` at the same rate and
    without a clip: a captured slab, then a timed and a profiled one;
    between them :func:`obs_bert_probe` reads the live gauges of this
    executor's captured step."""
    main, startup, out, lr, _ = build_bert_lamb(cfg, B, S, P, "adam")
    fetch = [out["loss"], lr]
    exe, scope = fluid.Executor(place), fluid.Scope()
    cuda = exe.device.type == "cuda"
    exe.run(startup, scope=scope)
    got = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=scope)
    _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=fetch, scope=scope))
    rec = {"optimizer": "AdamOptimizer(lr)", "clip": None,
           "losses": [float(x) for x in got[0]],
           "run_steps_ms_per_step": ms / K}
    obs_bert_probe(torch, np, fluid, exe, main, slab, fetch, scope, feed,
                   cfg, B, S, P, K)
    if cuda:
        dev, n = profiled_launches(torch, lambda: exe.run_steps(
            main, feed=slab, fetch_list=fetch, scope=scope))
        rec["device_ms_per_step_run_steps"] = dev / K
        rec["kernels_per_replay"] = n / K
        rec["adam_update_ops"] = optimizer_ops(exe, main,
                                               [out["loss"].name])
    del scope
    _release(torch, exe)
    return rec


def build_resnet_opt(run, optimizer):
    """bench_resnet50's program (bf16 AMP, batch_norm white-listed,
    static loss scale 1.0) under ``optimizer``: ``momentum`` (Momentum
    0.9 at the recipe's piecewise decay), ``momentum_l2`` (the same with
    ``L2Decay(1e-4)``, the PaddlePaddle/models ResNet-50 recipe) or
    ``lars`` (``LarsMomentumOptimizer(lr, 0.9, lars_coeff=0.001,
    lars_weight_decay=5e-5)``). Returns (main, startup, outputs, the
    regularizer's ``_OpsOf`` or None)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    reg = None
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(
            depth=run["depth"], class_dim=run["classes"],
            image_shape=(3, run["hw"], run["hw"]), batch_size=run["B"])
        # the recipe's 0.1 dropped 10x at epochs 30, 60, 90 (in steps of
        # ImageNet at B128)
        epoch = 1281167 // run["B"]
        lr = fluid.layers.piecewise_decay(
            [30 * epoch, 60 * epoch, 90 * epoch], [0.1, 0.01, 0.001, 1e-4])
        if optimizer == "lars":
            opt = fluid.optimizer.LarsMomentumOptimizer(
                lr, 0.9, lars_coeff=0.001, lars_weight_decay=5e-5)
        else:
            if optimizer == "momentum_l2":
                reg = _OpsOf(fluid.regularizer.L2Decay(1e-4))
            opt = fluid.optimizer.Momentum(lr, 0.9, regularization=reg)
        mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
            custom_white_list={"batch_norm"}), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(out["loss"])
    return main, startup, out, reg


def resnet_l2(torch, np, place=None, run=RESNET50, K=4, seed=0):
    """ResNet-50 at bench_resnet50's shape under plain Momentum, Momentum
    with ``L2Decay(1e-4)`` and LARS, in that order, each from its own
    seeded startup over the two-batch device pool: K eager steps against
    a ``run_steps`` slab of K from copies of one scope (losses and scope
    bitwise, FLAGS_cudnn_deterministic on), then a timed and a profiled
    slab (ms and device ms a step), the update ops the pass pipeline
    leaves (fused_momentum over the regularized grads; one
    lars_momentum per parameter), and, for L2, the device ms of the
    regularizer's ops in an eager step."""
    import paddle_tpu_torch as fluid
    rec = {"phase": "resnet_l2", **CARD, "B": run["B"], "image": run["hw"],
           "classes": run["classes"], "depth": run["depth"], "K": K,
           "amp": "bf16, batch_norm white-listed, static loss scale 1.0"}
    failures = []
    for name in ("momentum", "momentum_l2", "lars"):
        main, startup, out, reg = build_resnet_opt(run, name)
        loss = out["loss"]
        exe = fluid.Executor(place)
        cuda = exe.device.type == "cuda"
        pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                          exe.device, seed)
        slab = {n: torch.stack([pool[k % 2][n] for k in range(K)])
                for n in pool[0]}
        scope0 = fluid.Scope()
        exe.run(startup, scope=scope0)
        sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
        del scope0
        eager, wall = [], []
        for k in range(K):
            lv, ms = _timed_wall(torch, cuda, lambda k=k: exe.run(
                main, feed=pool[k % 2], fetch_list=[loss], scope=sA)[0])
            eager.append(lv)
            wall.append(ms)
        got = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)[0]
        diff = scope_diff(torch, sA, sB)
        r = {"eager_losses": [float(x) for x in eager],
             "run_steps_losses": [float(x) for x in got],
             "bitwise": bool(np.array_equal(got, np.stack(eager)))
             and not diff, "scope_diff": diff[:8],
             "update_ops": optimizer_ops(exe, main, [loss.name]),
             "eager_ms_per_step_median": float(np.median(wall[1:]))}
        _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=sB))
        r["run_steps_ms_per_step"] = ms / K
        r["images_per_s_run_steps"] = \
            run["B"] / r["run_steps_ms_per_step"] * 1e3
        if cuda:
            dev, n = profiled_launches(torch, lambda: exe.run_steps(
                main, feed=slab, fetch_list=[loss], scope=sB))
            r["device_ms_per_step_run_steps"] = dev / K
            r["kernels_per_replay"] = n / K
            if reg is not None:
                undo = _op_annotations(torch, _op_label(
                    (), {"regularizer": reg}))
                try:
                    dev, ranges = _range_device_ms(torch, lambda: exe.run(
                        main, feed=pool[0], fetch_list=[loss], scope=sA),
                        ("regularizer",))
                finally:
                    undo()
                r["device_ms_per_step_eager"] = dev
                r["regularizer_ops_device_ms"] = ranges.get("regularizer")
        if reg is not None:
            r["regularizer_ops"] = sum(
                op.output_arg_names[0] in reg.names
                for op in main.global_block().ops if op.output_arg_names)
        rec[name] = r
        ups = r["update_ops"]
        if not r["bitwise"]:
            failures.append(f"{name}: run_steps is not its eager steps "
                            f"(diff {diff[:8]})")
        if not all(np.isfinite(r["run_steps_losses"])):
            failures.append(f"{name}: non-finite losses")
        if name != "lars" and ("momentum" in ups or
                               not ups.get("fused_momentum")):
            failures.append(f"{name}: momentum not fused: {ups}")
        n_params = len(main.all_parameters())
        if name == "lars":
            ups = {t: sum(op.type == t for op in exe._optimize(
                main, [loss.name]).global_block().ops)
                for t in ("lars_momentum",)}
            r["update_ops"] = ups
            if ups["lars_momentum"] != n_params:
                failures.append(f"lars: {ups} for {n_params} parameters")
        del sA, sB
        _release(torch, exe)
    if "device_ms_per_step_run_steps" in rec["momentum"]:
        for name in ("momentum_l2", "lars"):
            rec[f"{name}_minus_momentum_ms_per_step"] = \
                rec[name]["run_steps_ms_per_step"] - \
                rec["momentum"]["run_steps_ms_per_step"]
            rec[f"{name}_minus_momentum_device_ms_per_step"] = \
                rec[name]["device_ms_per_step_run_steps"] - \
                rec["momentum"]["device_ms_per_step_run_steps"]
    rec["ok"] = not failures
    emit(rec)
    if failures:
        raise AssertionError(f"resnet_l2: {failures}")
    return rec


def _zoo_cases(fluid):
    """{name: builder(loss) -> wrapper or None} for the optimizer zoo:
    every optimizer and wrapper the slice ports, and the clip and
    regularizer variants. A builder appends its update to the current
    program; EMA and ModelAverage return themselves for apply()."""
    O, C, R = fluid.optimizer, fluid.clip, fluid.regularizer

    def plain(make):
        def build(loss):
            make().minimize(loss)
        return build

    def ema(loss):
        O.Adam(0.002).minimize(loss)
        e = O.ExponentialMovingAverage(0.9)
        e.update()
        return e

    def model_average(loss):
        O.SGD(0.1).minimize(loss)
        return O.ModelAverage(0.5, min_average_window=2,
                              max_average_window=3)

    return {
        "lamb": plain(lambda: O.Lamb(0.01)),
        "lars_momentum": plain(lambda: O.LarsMomentum(0.1, 0.9)),
        "adagrad": plain(lambda: O.Adagrad(0.005)),
        "decayed_adagrad": plain(lambda: O.DecayedAdagrad(0.001)),
        "adadelta": plain(lambda: O.Adadelta(1.0)),
        "adamax": plain(lambda: O.Adamax(0.002)),
        "rmsprop_centered": plain(lambda: O.RMSProp(
            0.0005, momentum=0.5, centered=True)),
        "ftrl": plain(lambda: O.Ftrl(0.01, l1=1e-3, l2=1e-3)),
        "dpsgd": plain(lambda: O.Dpsgd(0.05, clip=1.0, sigma=0.5)),
        "dgc_momentum": plain(lambda: O.DGCMomentumOptimizer(
            0.05, 0.9, rampup_begin_step=3, sparsity=[0.9])),
        "lookahead": plain(lambda: O.LookaheadOptimizer(O.Adam(0.002),
                                                        alpha=0.5, k=3)),
        "ema": ema,
        "model_average": model_average,
        "sgd_l1": plain(lambda: O.SGD(0.1, regularization=R.L1Decay(1e-3))),
        "momentum_clip_by_value": plain(lambda: O.Momentum(
            0.05, 0.9, grad_clip=C.GradientClipByValue(0.01))),
        "adam_clip_by_norm": plain(lambda: O.Adam(
            0.002, grad_clip=C.GradientClipByNorm(0.05))),
        "adamw_l2_global_norm": plain(lambda: O.AdamW(
            0.002, regularization=R.L2Decay(1e-3),
            grad_clip=C.GradientClipByGlobalNorm(0.1))),
    }


def optimizer_zoo(torch, np, place=None, B=256, K=8, seed=51):
    """Every optimizer and wrapper of the slice on a 2-layer MLP (784 ->
    512 -> 10, softmax cross-entropy), K steps: K eager ``Executor.run``
    steps against a ``run_steps`` slab of K from copies of one scope,
    losses and scope bitwise, the slab a captured graph (no
    ``GraphCaptureError``); dpsgd's noise and DGC's top-k threshold
    (dense up to step 3, sparse after) drawn and taken in the capture as
    in the eager steps. For EMA and ModelAverage, between two slabs of
    K/2, ``apply()`` swaps the averages into the scope that the captured
    step holds (they must differ from the weights) and ``restore()``
    swaps the weights back; the eager twin does the same, and the second
    slab (which reads the restored weights) stays bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rng = np.random.default_rng(seed)
    feeds = [{"x": torch.from_numpy(rng.standard_normal(
                  (B, 784)).astype(np.float32)).to(exe.device),
              "y": torch.from_numpy(rng.integers(
                  0, 10, (B, 1)).astype(np.int64)).to(exe.device)}
             for _ in range(K)]
    rec = {"phase": "optimizer_zoo", **CARD, "B": B, "K": K,
           "model": "MLP 784-512-10", "cases": {}}
    failures = []
    names = sorted(_zoo_cases(fluid))
    for name in names:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 784], "float32")
            y = fluid.data("y", [-1, 1], "int64")
            h = fluid.layers.fc(x, 512, act="relu")
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    fluid.layers.fc(h, 10), y))
            swap = _zoo_cases(fluid)[name](loss)
        scope0 = fluid.Scope()
        exe.run(startup, scope=scope0)
        sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
        del scope0
        halves = (range(K // 2), range(K // 2, K)) if swap else (range(K),)
        eager, got, swapped = [], [], []
        try:
            for part in halves:
                for k in part:
                    eager.append(exe.run(main, feed=feeds[k],
                                         fetch_list=[loss], scope=sA)[0])
                slab = {n: torch.stack([feeds[k][n] for k in part])
                        for n in feeds[0]}
                got.append(exe.run_steps(main, feed=slab, fetch_list=[loss],
                                         scope=sB)[0])
                if swap and part is halves[0]:
                    for s in (sA, sB):
                        with fluid.scope_guard(s):
                            w = s.find_var("fc_0.w_0").clone()
                            with swap.apply():
                                swapped.append(not torch.equal(
                                    s.find_var("fc_0.w_0"), w))
                            swapped.append(torch.equal(
                                s.find_var("fc_0.w_0"), w))
        except GraphCaptureError as e:
            failures.append(f"{name}: the step did not capture: {e}")
            continue
        got = np.concatenate(got)
        diff = scope_diff(torch, sA, sB)
        captured = (_captured(exe).graph is not None) if cuda else None
        ok = bool(np.array_equal(got, np.stack(eager))) and not diff \
            and all(np.isfinite(got)) and all(swapped) \
            and captured is not False
        rec["cases"][name] = {"losses": [float(v) for v in got],
                              "bitwise": ok, "scope_diff": diff[:4],
                              "captured": captured,
                              "swap_checks": swapped}
        if not ok:
            failures.append(f"{name}: {rec['cases'][name]}")
        exe.close()
    rec["ok"] = not failures
    emit(rec)
    if failures:
        raise AssertionError(f"optimizer_zoo: {failures}")
    return rec


def dygraph_clip(torch, np, place=None, run=None):
    """PR 12's dygraph_transformer path (the dygraph Transformer-base at
    B256, all 6+6 layers) with ``grad_clip=GradientClipByGlobalNorm(1.0)``
    and ``regularization=L2Decay(1e-4)`` on its Adam: the clip and the
    decay run in torch inside the ``jit_step`` capture, and a replay from
    a copied state is bitwise ``CompiledStep.eager`` from that state."""
    import paddle_tpu_torch as fluid
    return dygraph_transformer(
        torch, np, place, run=run or dict(DY_TRANSFORMER, timed=5),
        name="dygraph_clip",
        opt_kw={"grad_clip": fluid.clip.GradientClipByGlobalNorm(1.0),
                "regularization": fluid.regularizer.L2Decay(1e-4)})



# ------------------------------------------ data parallelism across cards

DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")
DP_PARITY = {"b": 8, "hw": 16, "classes": 10, "steps": 3}
# sync batch norm in bf16 at ResNet-50's widths and image size: one
# data-parallel step against the plain program's on the global batch
DP_SYNC_BN_BF16 = {"depth": 50, "classes": 1000, "b": 8, "hw": 224,
                   "limit": 0.1, "op_limit": 2e-2}
DP_BERT = {"B": 16, "S": 2048, "P": 64, "K": 4}
DP_RESNET = dict(RESNET50, K=4)
DP_BERT_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_single")


# the one-card worker that serves every phase of a family in one process
# (``resident``): its process, log and request count
_RESIDENT = {}


class resident:
    """A context in which every phase launched at N = 1 runs in one
    worker process (one rank through the port's launcher, started once,
    ``--dp-serve``) instead of a process of its own: the phases share a
    process start, an ``import torch`` and a CUDA context, which a
    one-card run otherwise pays per phase. Each phase still zeroes the kernel counts before it and
    writes its own record; the worker stops on exit."""

    def __init__(self, torch, on=True, cpu=False):
        self.torch, self.on, self.cpu = torch, on, cpu

    def __enter__(self):
        if not self.on:
            return self
        folder = os.path.join(DP_DIR, "resident")
        os.makedirs(folder, exist_ok=True)
        for f in os.listdir(folder):
            os.remove(os.path.join(folder, f))
        log = open(os.path.join(folder, "worker.log"), "w")
        cmd = [sys.executable, os.path.join(
            ROOT, "paddle_tpu_torch", "distributed", "launch.py"),
            "--nproc_per_node=1"] + (["--device=cpu"] if self.cpu else []) \
            + [os.path.abspath(__file__), "--dp-serve", folder]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        _RESIDENT.update(proc=proc, folder=folder, log=log, k=0)
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import signal
        proc, folder = _RESIDENT["proc"], _RESIDENT["folder"]
        open(os.path.join(folder, "stop"), "w").close()
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        _RESIDENT["log"].close()
        _RESIDENT.clear()
        return False


def _resident_run(phase, args, timeout):
    """``phase`` with ``args`` run by the resident worker; returns the
    seconds it took, or raises with the worker's output when the phase
    fails, the worker dies or ``timeout`` passes (the worker is
    killed)."""
    import signal
    proc, folder = _RESIDENT["proc"], _RESIDENT["folder"]
    k = _RESIDENT["k"]
    _RESIDENT["k"] = k + 1
    tmp = os.path.join(folder, f"req.{k}.tmp")
    with open(tmp, "w") as f:
        json.dump(args, f)
    os.replace(tmp, os.path.join(folder, f"req.{k}.json"))
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(folder, f"done.{k}")):
        dead = proc.poll() is not None
        late = time.perf_counter() - t0 > timeout
        if dead or late:
            if not dead:
                os.killpg(proc.pid, signal.SIGKILL)
            _RESIDENT["log"].flush()
            with open(os.path.join(folder, "worker.log")) as f:
                print(f.read()[-6000:], file=sys.stderr)
            raise AssertionError(
                f"{phase} at N=1 (resident worker): "
                + (f"outlived {timeout} s" if late else
                   f"the worker exited {proc.returncode}"))
        time.sleep(0.05)
    return time.perf_counter() - t0


def dp_serve(folder):
    """The resident one-card worker (``--dp-serve``): joins the world of
    1 the launcher set up once, then runs each phase request
    ``req.<k>.json`` in turn as ``--dp-worker`` would and marks it
    ``done.<k>``, until ``stop``. A failing phase ends the worker."""
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.parallel import mesh
    mesh.init_parallel_env()
    k = 0
    while True:
        req = os.path.join(folder, f"req.{k}.json")
        if os.path.exists(req):
            _run_phase(req)
            open(os.path.join(folder, f"done.{k}"), "w").close()
            k += 1
        elif os.path.exists(os.path.join(folder, "stop")):
            return 0
        else:
            time.sleep(0.05)


def dp_launch(torch, phase, nproc, args=None, timeout=900):
    """Run ``phase``'s worker on ``nproc`` ranks through the port's
    launcher (``paddle_tpu_torch/distributed/launch.py``, one process a
    card; run as a script, since it needs nothing of the package and
    ``-m`` would import the package, torch included, for nothing;
    ``args["cpu"]`` runs gloo ranks on the CPU, a rehearsal), this file
    being each rank's script (``--dp-worker``).
    The parent's garbage and cached blocks are released first, and its
    reserved bytes recorded beside the launch. Returns (each rank's
    record, the launch's record); raises with the ranks' output when the
    launch fails or outlives ``timeout`` (its process group is killed)."""
    import signal
    args = dict(args or {}, phase=phase)
    cuda = not args.get("cpu") and torch.cuda.is_available()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    launch = {"nproc": nproc, "parent_reserved_gb":
              torch.cuda.memory_reserved() / 1e9 if cuda else None,
              "parent_allocated_gb":
              torch.cuda.memory_allocated() / 1e9 if cuda else None}
    os.makedirs(DP_DIR, exist_ok=True)
    for f in os.listdir(DP_DIR):
        if f.startswith(f"{phase}.n{nproc}."):
            os.remove(os.path.join(DP_DIR, f))
    argpath = os.path.join(DP_DIR, f"{phase}.n{nproc}.args.json")
    with open(argpath, "w") as f:
        json.dump(args, f)
    if nproc == 1 and _RESIDENT:
        launch["seconds"] = _resident_run(phase, args, timeout)
        launch["resident"] = True
        with open(os.path.join(DP_DIR, f"{phase}.n1.r0.json")) as f:
            return [json.load(f)], launch
    cmd = [sys.executable, os.path.join(ROOT, "paddle_tpu_torch",
                                        "distributed", "launch.py"),
           f"--nproc_per_node={nproc}"] + \
        (["--device=cpu"] if args.get("cpu") else []) + \
        [os.path.abspath(__file__), "--dp-worker", argpath]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-6000:], file=sys.stderr)
        raise AssertionError(f"{phase} at N={nproc} outlived {timeout} s")
    launch["seconds"] = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-6000:], file=sys.stderr)
        raise AssertionError(f"{phase} at N={nproc}: the launch exited "
                             f"{proc.returncode}")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(DP_DIR, f"{phase}.n{nproc}.r{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, launch


def dp_worker(argpath):
    """One rank of a data-parallel phase (``--dp-worker``): joins the
    world the launcher set up, runs the phase's worker and writes its
    record to ``build/chip_smoke_dp/<phase>.n<N>.r<rank>.json``."""
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.parallel import mesh
    mesh.init_parallel_env()
    return _run_phase(argpath)


def _run_phase(argpath):
    """The phase of ``argpath``'s args on this rank of the joined world:
    the kernel counts zeroed, its worker run, its record written."""
    import numpy as np
    import torch
    with open(argpath) as f:
        args = json.load(f)
    from paddle_tpu_torch.parallel import mesh
    rank, n = mesh.rank(), mesh.world_size()
    place = None
    if args.get("cpu"):
        import paddle_tpu_torch as fluid
        torch.set_num_threads(1)
        place = fluid.CPUPlace()
    fn = {"dp_parity": _dp_parity, "dp_resnet50": _dp_resnet50,
          "fleet_bert": _fleet_bert, "tp_parity": _tp_parity,
          "tp_bert": _tp_bert, "tp_generate": _tp_generate,
          "tp_serving": _tp_serving, "sp_parity": _sp_parity,
          "sp_bert": _sp_bert, "pp_parity": _pp_parity,
          "pp_gpt": _pp_gpt, "moe_parity": _moe_parity,
          "moe_gpt": _moe_gpt, "dcn_bert": _dcn_bert,
          "slice_drill": _slice_drill}[args["phase"]]
    from paddle_tpu_torch import kernels
    for w in kernels.COUNTED:
        w.launches = 0
        if hasattr(w, "bf16_launches"):
            w.bf16_launches = 0
    rec = fn(torch, np, args, rank, n, place)
    rec["rank"], rec["n"] = rank, n
    rec["launches"] = {w.__name__: w.launches for w in kernels.COUNTED}
    rec["bf16_launches"] = {w.__name__: w.bf16_launches
                            for w in kernels.COUNTED
                            if hasattr(w, "bf16_launches")}
    with open(os.path.join(DP_DIR, f"{args['phase']}.n{n}.r{rank}.json"),
              "w") as f:
        json.dump(rec, f)
    mesh.barrier()
    return 0


def _state_digest(torch, items):
    """{name: sha256 of its bytes} of every tensor of ``items`` ((name,
    value) pairs: a scope's, or a dict's)."""
    import hashlib
    out = {}
    for n, v in sorted(items, key=lambda kv: kv[0]):
        if isinstance(v, torch.Tensor):
            b = v.detach().contiguous().view(torch.uint8) if v.dim() else \
                v.detach().reshape(1).view(torch.uint8)
            out[n] = hashlib.sha256(b.cpu().numpy().tobytes()).hexdigest()
    return out


def _rel_err(np, got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _dp_parity(torch, np, args, rank, n, place):
    """The contract at small width, float32, on N ranks: a conv +
    batch_norm + fc classifier under Momentum and a dygraph MLP under
    Adam with DataParallel and jit_step, each 3 steps on this rank's
    rows of a seeded global batch; rank 0 also runs each plainly on the
    whole global batch on its card. Records the parameters' digests,
    rank 0's error against its plain run, and whether a run_steps slab
    is bitwise the eager steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.dygraph import layers as dylayers
    p = DP_PARITY
    b, hw, classes, steps = p["b"], p["hw"], p["classes"], p["steps"]
    G = b * n
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("image", [-1, 3, hw, hw], "float32")
        y = fluid.data("label", [-1, 1], "int64")
        h = layers.conv2d(x, 8, 3, padding=1, bias_attr=False)
        h = layers.batch_norm(h, act="relu")
        h = layers.pool2d(h, 2, pool_stride=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, classes), y))
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
    rng = np.random.default_rng(7)
    feeds = [{"image": rng.standard_normal((G, 3, hw, hw))
              .astype(np.float32),
              "label": rng.integers(0, classes, (G, 1)).astype(np.int64)}
             for _ in range(steps)]
    mine = [{k: v[rank * b:(rank + 1) * b] for k, v in f.items()}
            for f in feeds]
    exe = fluid.Executor(place)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    sA, sB = fluid.Scope(), fluid.Scope()
    for s in (sA, sB):
        exe.run(startup, scope=s)
    eager = [exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
             for f in mine]
    slab = exe.run_steps(comp, feed=mine, fetch_list=[loss], scope=sB)[0]
    diff = scope_diff(torch, sA, sB)
    rec = {"static": {
        "losses": [float(np.ravel(v)[0]) for v in eager],
        "slab_bitwise": bool(np.array_equal(np.stack(eager).reshape(-1),
                                            np.asarray(slab).reshape(-1)))
        and not diff, "scope_diff": diff[:8],
        "digest": _state_digest(torch, sB.items()),
        "sync_batch_norm_ops": sum(op.type == "sync_batch_norm" for op in
                                   comp.program.global_block().ops)}}
    if rank == 0:
        sR = fluid.Scope()
        exe.run(startup, scope=sR)
        plain = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=sR)[0])[0]) for f in feeds]
        rec["static"]["plain_losses"] = plain
        rec["static"]["max_rel_err"] = max(
            _rel_err(np, sA.find_var(q.name).cpu().numpy(),
                     sR.find_var(q.name).cpu().numpy())
            for q in main.all_parameters())
    # dygraph: DataParallel + jit_step, the reference's step
    drng = np.random.default_rng(9)
    dfeeds = [(drng.standard_normal((G, 32)).astype(np.float32),
               drng.standard_normal((G, 10)).astype(np.float32))
              for _ in range(steps)]

    def mlp():
        dylayers.set_init_seed(3)
        m = dygraph.Sequential(dygraph.Linear(32, 64, act="tanh"),
                               dygraph.Linear(64, 10))
        return m

    def step_fn(model, opt, dp):
        def step(xv, yv):
            lv = layers.mean(layers.square(layers.elementwise_sub(
                model(xv), yv)))
            if dp:
                lv = model.scale_loss(lv)
            lv.backward()
            if dp:
                model.apply_collective_grads()
            opt.minimize(lv)
            model.clear_gradients()
            return lv
        return step

    with dygraph.guard(place):
        model = dygraph.DataParallel(mlp(), dygraph.prepare_context())
        opt = fluid.optimizer.Adam(0.01, parameter_list=model.parameters())
        run = dygraph.jit_step(step_fn(model, opt, True))
        dl = [float(run(dygraph.to_variable(xv[rank * b:(rank + 1) * b]),
                        dygraph.to_variable(yv[rank * b:(rank + 1) * b]))
                    .numpy().reshape(-1)[0]) * n for xv, yv in dfeeds]
        rec["dygraph"] = {"losses": dl, "digest": _state_digest(
            torch, [(q.name, q.value) for q in model.parameters()])}
        if rank == 0:
            ref = mlp()
            ropt = fluid.optimizer.Adam(0.01,
                                        parameter_list=ref.parameters())
            rstep = step_fn(ref, ropt, False)
            rl = [float(rstep(dygraph.to_variable(xv),
                              dygraph.to_variable(yv)).numpy()
                        .reshape(-1)[0]) for xv, yv in dfeeds]
            rec["dygraph"]["plain_losses"] = rl
            rec["dygraph"]["max_rel_err"] = max(
                _rel_err(np, a.numpy(), r.numpy()) for a, r in
                zip(model.parameters(), ref.parameters()))
    rec["sync_bn_bf16"] = _sync_bn_bf16(
        torch, np, fluid, exe, rank, n,
        dict(DP_SYNC_BN_BF16, **args.get("sync_bn_bf16", {})))
    return rec


class _OpCtx:
    """The little of a lowering context that one op and its grad read:
    the op (its type and output ``Y``), and the values the forward keeps
    for the grad."""

    abstract = False

    def __init__(self, op_type):
        class Op:
            type = op_type

            @staticmethod
            def output(slot):
                return [slot]
        self.op, self.saved = Op, {}

    def save_for_grad(self, name, value):
        self.saved[name] = value

    def take_saved(self, name):
        return self.saved.pop(name, None)


def sync_bn_op_check(torch, np, rank, n, device, shapes, seed=23):
    """The sync_batch_norm op and its grad in bf16 (the lowerings the
    executor calls: on the card torch's fused kernels with this world's
    all-gather and all-reduce, on the CPU the shifted-sum all-reduce),
    and the plain batch_norm op in bf16 on the whole global batch,
    against float32 autograd of ``F.batch_norm`` on the global batch:
    for each [N, C, H, W] of ``shapes`` (this rank's rows; the global
    batch has n times as many, made from ``seed`` on every rank), the
    error of Y and X@GRAD (this rank's rows), Scale@GRAD and Bias@GRAD
    (summed over the ranks) and MeanOut/VarianceOut, each over max |ref|."""
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.collective_ops import all_reduce
    F = torch.nn.functional
    out = []
    for k, (b, C, H, W) in enumerate(shapes):
        g = torch.Generator().manual_seed(seed + k)
        xg = (torch.randn((b * n, C, H, W), generator=g) * 2 + 0.5)
        dyg = torch.randn((b * n, C, H, W), generator=g)
        w = torch.rand(C, generator=g) + 0.5
        bias = torch.randn(C, generator=g)
        rm, rv = torch.randn(C, generator=g), torch.rand(C, generator=g) + 1
        xg, dyg = (t.to(device, torch.bfloat16) for t in (xg, dyg))
        w, bias, rm, rv = (t.to(device) for t in (w, bias, rm, rv))
        # float32 reference on the global batch (the bf16 values, widened)
        xr = xg.float().requires_grad_()
        wr, br = w.clone().requires_grad_(), bias.clone().requires_grad_()
        mr, vr = rm.clone(), rv.clone()
        yr = F.batch_norm(xr, mr, vr, wr, br, training=True, momentum=0.1,
                          eps=1e-5)
        yr.backward(dyg.float())
        var = xr.detach().var(dim=(0, 2, 3), unbiased=False)
        mean = xr.detach().mean(dim=(0, 2, 3))
        ref = {"Y": yr.detach(), "X@GRAD": xr.grad, "Scale@GRAD": wr.grad,
               "Bias@GRAD": br.grad, "MeanOut": rm * 0.9 + mean * 0.1,
               "VarianceOut": rv * 0.9 + var * 0.1}
        rows = slice(rank * b, (rank + 1) * b)
        row = {"shape": [b, C, H, W]}
        for op, xs, dys, mine in (("sync_batch_norm", xg[rows], dyg[rows],
                                   True),
                                  ("batch_norm", xg, dyg, False)):
            ctx = _OpCtx(op)
            attrs = {"epsilon": 1e-5, "momentum": 0.9,
                     "data_layout": "NCHW"}
            ins = {"X": [xs], "Scale": [w], "Bias": [bias], "Mean": [rm],
                   "Variance": [rv]}
            fwd = getattr(nn_ops, op)(ctx, ins, attrs)
            grads = getattr(nn_ops, op + "_grad")(ctx, dict(
                ins, **{"Y@GRAD": [dys]}), {
                "__fwd_op__": {"attrs": attrs, "outputs": {"Y": ["Y"]}},
                "__grad_inputs__": {"X": [True], "Scale": [True],
                                    "Bias": [True]}})
            got = {"Y": fwd["Y"], "MeanOut": fwd["MeanOut"],
                   "VarianceOut": fwd["VarianceOut"],
                   "X@GRAD": grads["X@GRAD"][0],
                   "Scale@GRAD": grads["Scale@GRAD"][0].float(),
                   "Bias@GRAD": grads["Bias@GRAD"][0].float()}
            if mine:
                for slot in ("Scale@GRAD", "Bias@GRAD"):
                    all_reduce(got[slot], "sum")
            err = {}
            for slot, r in ref.items():
                r = r[rows] if mine and slot in ("Y", "X@GRAD") else r
                err[slot] = float((got[slot].float() - r).abs().max()) / \
                    max(float(r.abs().max()), 1e-30)
            row[op] = err
        out.append(row)
    return out


def _sync_bn_bf16(torch, np, fluid, exe, rank, n, p):
    """Sync batch norm in bf16 at ResNet-50's widths. First the ops
    (:func:`sync_bn_op_check` at ResNet-50's batch-norm shapes with
    ``p["b"]`` rows a rank). Then bench_resnet50's program (bf16 AMP,
    batch_norm white-listed, Momentum) at its image size: one step
    through ``with_data_parallel`` (every batch_norm a sync_batch_norm,
    the path dp_resnet50 times) from a copy of one startup; on rank 0 one
    step of the plain program (batch_norm) on the global batch from
    another copy, and one of the float32 program from the same values.
    Per group of tensors (conv and fc weights, BN scales, BN biases, BN
    running means, BN running variances), the L2 norm of the difference
    of two steps' updates over the L2 norm of the second's: data-parallel
    against plain bf16 (``update_rel_l2``), and each against float32."""
    hw = p["hw"]
    shapes = [(p["b"], C, hw // s, hw // s) for C, s in
              ((64, 2), (256, 4), (512, 8), (1024, 16), (2048, 32))]
    rec = {"rows_per_rank": p["b"], "hw": hw, "depth": p["depth"],
           "limit": p["limit"], "op_limit": p["op_limit"],
           "ops": sync_bn_op_check(torch, np, rank, n, exe.device, shapes)}
    main, startup, out, _ = build_resnet(p["depth"], p["classes"], p["b"],
                                         hw, amp=True)
    loss = out["loss"]
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    G = p["b"] * n
    rng = np.random.default_rng(11)
    feed = {"image": rng.standard_normal((G, 3, hw, hw)).astype(np.float32),
            "label": rng.integers(0, p["classes"], (G, 1)).astype(np.int64)}
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    sD = copied_scope(torch, fluid, s0)
    exe.run(comp, feed={k: v[rank * p["b"]:(rank + 1) * p["b"]]
                        for k, v in feed.items()},
            fetch_list=[loss], scope=sD)
    rec.update({"sync_batch_norm_ops": sum(
        o.type == "sync_batch_norm" for o in comp.program.global_block().ops),
        "digest": _state_digest(torch, [(q.name, sD.find_var(q.name))
                                        for q in main.all_parameters()])})
    if rank == 0:
        sR = copied_scope(torch, fluid, s0)
        exe.run(main, feed=feed, fetch_list=[loss], scope=sR)
        m32, st32, out32, _ = build_resnet(p["depth"], p["classes"], p["b"],
                                           hw, amp=False)
        sF = fluid.Scope()
        exe.run(st32, scope=sF)
        for name, v in sF.items():
            if isinstance(v, torch.Tensor) and s0.find_var(name) is not None:
                sF.set(name, s0.find_var(name).clone())
        exe.run(m32, feed=feed, fetch_list=[out32["loss"]], scope=sF)
        groups = {"weights": [], "bn_scale": [], "bn_bias": [],
                  "bn_mean": [], "bn_variance": []}
        bn = set()
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                for slot, g in (("Scale", "bn_scale"), ("Bias", "bn_bias"),
                                ("Mean", "bn_mean"),
                                ("Variance", "bn_variance")):
                    groups[g].append(op.input(slot)[0])
                    bn.add(op.input(slot)[0])
        groups["weights"] = [q.name for q in main.all_parameters()
                             if q.name not in bn]

        def update_err(a, b):
            errs = {}
            for g, names in groups.items():
                num = den = 0.0
                for name in names:
                    v0 = s0.find_var(name).double()
                    ref = b.find_var(name).double() - v0
                    d = (a.find_var(name).double() - v0) - ref
                    num += float(d.square().sum())
                    den += float(ref.square().sum())
                errs[g] = (num / max(den, 1e-300)) ** 0.5
            return errs
        rec.update({"tensors": {g: len(v) for g, v in groups.items()},
                    "update_rel_l2": update_err(sD, sR),
                    "dp_vs_fp32": update_err(sD, sF),
                    "plain_vs_fp32": update_err(sR, sF)})
        del sR, sF
    del s0, sD
    return rec


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def kernel_profile(torch, fn):
    """One call of ``fn`` under torch.profiler: ``wall_ms`` (the host's
    clock from just before the call to after a device sync, inside the
    profiler), ``busy_ms`` (the union of every device kernel, copy and
    set interval on any stream: time the card did something, NCCL's
    spinning included), ``kernel_sum_ms`` (their durations added over
    the streams), ``nccl_us`` (each NCCL kernel's duration in start
    order), ``nccl_busy_ms`` (the union of those), ``nccl_by_kind``
    ({kernel name: [count, ms]}) and ``compute_busy_ms`` (the union of
    the rest)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, nccl, other, total, by_kind = [], [], [], 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "device_time", None)
        t = float(e.cuda_time if t is None else t)
        total += t
        span = (float(e.time_range.start), float(e.time_range.end))
        spans.append(span)
        if "nccl" in e.name.lower():
            nccl.append(span)
            kind = by_kind.setdefault(e.name, [0, 0.0])
            kind[0] += 1
            kind[1] += t / 1e3
        else:
            other.append(span)
    nccl.sort()
    return {"wall_ms": wall, "busy_ms": _union_us(spans) / 1e3,
            "nccl_by_kind": by_kind,
            "kernel_sum_ms": total / 1e3,
            "nccl_us": [b - a for a, b in nccl],
            "nccl_busy_ms": _union_us(nccl) / 1e3,
            "compute_busy_ms": _union_us(other) / 1e3}


def nccl_wait_split(ranks):
    """Each rank's NCCL time split into transfer and wait: every rank
    issues the same collectives in the same order, and the i-th one's
    kernel lasts on each rank from its own launch to the slowest
    rank's arrival plus the transfer. The shortest of the ranks' i-th
    kernels (the last to arrive) is taken as its transfer; the rest of
    each rank's kernel is waiting for the others. Returns [(transfer
    ms, wait ms)] by rank, or None when the ranks' NCCL kernels do not
    pair up one to one."""
    lists = [r["nccl_us"] for r in ranks]
    if not lists or any(len(x) != len(lists[0]) for x in lists):
        return None
    floor = [min(col) for col in zip(*lists)]
    transfer = sum(floor) / 1e3
    return [(transfer, (sum(x) - sum(floor)) / 1e3) for x in lists]


def _dp_train(torch, np, fluid, exe, comp, startup, loss, pool, K,
              label_ops, startup_scope=None):
    """The shared body of dp_resnet50 and fleet_bert on one rank: K eager
    steps and a run_steps slab of K from copies of one scope (losses and
    scope bitwise), a timed slab, a profiled slab (device, NCCL and
    idle), the device ms of ``label_ops`` in an annotated eager step,
    and the peak memory. Returns the record and the slab scope."""
    cuda = exe.device.type == "cuda"
    base = _peak_base(torch, cuda)
    scope0 = startup_scope or fluid.Scope()
    if startup_scope is None:
        exe.run(startup, scope=scope0)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    del scope0
    slab = {k: torch.stack([pool[i % len(pool)][k] for i in range(K)])
            for k in pool[0]}
    from paddle_tpu_torch import kernels
    eager, wall = [], []
    for i in range(K):
        lv, ms = _timed_wall(torch, cuda, lambda i=i: exe.run(
            comp, feed=pool[i % len(pool)], fetch_list=[loss],
            scope=sA)[0])
        eager.append(lv)
        wall.append(ms)
    (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        comp, feed=slab, fetch_list=[loss], scope=sB))
    diff = scope_diff(torch, sA, sB)
    before = {w.__name__: (w.launches, getattr(w, "bf16_launches", 0))
              for w in kernels.COUNTED}
    (got2,), slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        comp, feed=slab, fetch_list=[loss], scope=sB))
    per_step = {w.__name__: (w.launches - before[w.__name__][0]) / K
                for w in kernels.COUNTED}
    bf16_step = {w.__name__: (getattr(w, "bf16_launches", 0)
                              - before[w.__name__][1]) / K
                 for w in kernels.COUNTED}
    rec = {"K": K, "eager_losses": [float(np.ravel(v)[0]) for v in eager],
           "slab_losses": [float(v) for v in np.ravel(got)],
           "slab2_losses": [float(v) for v in np.ravel(got2)],
           "slab_bitwise": bool(np.array_equal(np.stack(eager).reshape(-1),
                                               np.ravel(got))) and not diff,
           "scope_diff": diff[:8],
           "eager_ms_per_step_median": float(np.median(wall[1:])),
           "first_slab_ms_with_capture": cap_ms,
           "run_steps_ms_per_step": slab_ms / K,
           "launches_per_step_run_steps": per_step,
           "bf16_launches_per_step_run_steps": bf16_step}
    rec["capture_s"] = max(cap_ms - slab_ms, 0.0) / 1e3
    if cuda:
        rec["profile"] = kernel_profile(torch, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=sB))
        rec["nccl_kernels_per_step"] = len(rec["profile"]["nccl_us"]) / K
        undo = _op_annotations(torch, _op_label(label_ops))
        try:
            edev, ranges = _range_device_ms(torch, lambda: exe.run(
                comp, feed=pool[0], fetch_list=[loss], scope=sA),
                tuple(f"op::{t}" for t in label_ops))
        finally:
            undo()
        rec["eager_device_ms"] = edev
        rec["eager_op_device_ms"] = {k: v for k, v in ranges.items()}
        rec["peak_mem_gb"] = _peak_from(torch, cuda, base)
    rec["digest"] = _state_digest(torch, sB.items())
    del sA, sB
    return rec


DP_LABEL_OPS = ("sync_batch_norm", "sync_batch_norm_grad",
                "c_coalesced_allreduce_sum")


def _dp_resnet50(torch, np, args, rank, n, place):
    """bench_resnet50's program (B128 224x224 a card, bf16 AMP with
    batch_norm white-listed, Momentum(0.1, 0.9)) through
    ``CompiledProgram(main).with_data_parallel(loss_name)``, this rank's
    own seeded two-batch pool, K steps eagerly and by run_steps."""
    import paddle_tpu_torch as fluid
    run = args["run"]
    main, startup, out, _ = build_resnet(run["depth"], run["classes"],
                                         run["B"], run["hw"],
                                         lr=run.get("lr", 0.1), amp=True)
    loss = out["loss"]
    exe = fluid.Executor(place)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device, seed=100 + rank)
    rec = _dp_train(torch, np, fluid, exe, comp, startup, loss, pool,
                    run["K"], DP_LABEL_OPS)
    ops = comp.program.global_block().ops
    rec.update({"B": run["B"], "image": run["hw"], "depth": run["depth"],
                "sync_batch_norm_ops": sum(o.type == "sync_batch_norm"
                                           for o in ops),
                "allreduce_buckets": sum(
                    o.type == "c_coalesced_allreduce_sum" for o in ops),
                "analytic_flops_per_step": conv_fc_flops_per_step(main)})
    _release(torch, exe)
    return rec


def _fleet_bert(torch, np, args, rank, n, place):
    """BERT-base at bench_bert_long's shape (flash, bf16 AMP, Adam at
    noam_decay) through the Fleet collective: fleet.init with
    PaddleCloudRoleMaker(is_collective=True), distributed_optimizer(opt)
    .minimize(loss), fleet.startup_program, then K eager steps and
    run_steps slabs of fleet.main_program on this rank's seeded batch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        PaddleCloudRoleMaker)
    from paddle_tpu_torch.incubate.fleet.collective import fleet
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    run = args["run"]
    B, S, P = run["B"], run["S"], run["P"]
    fleet.init(PaddleCloudRoleMaker(is_collective=True))
    cfg = bert_config(args.get("layers"), "flash", dropout=0.0,
                      max_position=max(S, 512))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0)
        opt = mp.decorate(fluid.optimizer.AdamOptimizer(lr),
                          init_loss_scaling=1.0,
                          use_dynamic_loss_scaling=False)
        fleet.distributed_optimizer(opt).minimize(out["loss"])
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(fleet.startup_program, scope=scope0)
    feed = bert.random_batch(cfg, B, S, P,
                             rng=np.random.default_rng(200 + rank))
    pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(exe.device)
             for k, v in feed.items()}]
    rec = _dp_train(torch, np, fluid, exe, fleet.main_program, startup,
                    out["loss"], pool, run["K"],
                    ("c_coalesced_allreduce_sum",), startup_scope=scope0)
    rec.update({"B": B, "S": S, "P": P, "layers": cfg.num_layers,
                "worker_index": fleet.worker_index(),
                "worker_num": fleet.worker_num(),
                "analytic_flops_per_step":
                    bert_train_flops_per_sample(cfg, S, P) * B})
    _release(torch, exe)
    return rec


def _dp_failures(name, ranks):
    """What the ranks' records say is wrong: parameters unequal across
    ranks, a slab that is not its eager steps, a non-finite loss."""
    bad = []
    digests = [r.get("digest") or r.get("static", {}).get("digest")
               for r in ranks]
    if any(d != digests[0] for d in digests[1:]):
        bad.append(f"{name}: state differs across ranks")
    for r in ranks:
        part = r.get("static", r)
        if not part.get("slab_bitwise", True):
            bad.append(f"{name}: rank {r['rank']}'s run_steps is not its "
                       f"eager steps ({part.get('scope_diff')})")
        losses = part.get("slab_losses", part.get("losses", []))
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: rank {r['rank']} non-finite {losses}")
    return bad


def dp_phase(torch, np, name, nproc, args=None, timeout=900):
    """One data-parallel phase at ``nproc`` ranks, checked and printed:
    the rank records reduced to the slowest rank's times, the totals and
    the card. Returns the record (``ranks`` holds each rank's)."""
    ranks, launch = dp_launch(torch, name, nproc, args, timeout)
    rec = {"phase": name, **CARD, "N": nproc, "launch": launch}
    bad = _dp_failures(name, ranks)
    r0 = ranks[0]
    if name == "dp_parity":
        st, dy = r0["static"], r0["dygraph"]
        rec.update({"static_max_rel_err": st["max_rel_err"],
                    "dygraph_max_rel_err": dy["max_rel_err"],
                    "static_slab_bitwise": all(
                        r["static"]["slab_bitwise"] for r in ranks),
                    "dygraph_ranks_equal": all(
                        r["dygraph"]["digest"] == dy["digest"]
                        for r in ranks),
                    "static_mean_losses": np.mean(
                        [r["static"]["losses"] for r in ranks], 0).tolist(),
                    "static_plain_losses": st["plain_losses"],
                    "dygraph_mean_losses": np.mean(
                        [r["dygraph"]["losses"] for r in ranks],
                        0).tolist(),
                    "dygraph_plain_losses": dy["plain_losses"],
                    "sync_batch_norm_ops": st["sync_batch_norm_ops"]})
        if st["max_rel_err"] > 1e-4 or dy["max_rel_err"] > 1e-4:
            bad.append(f"dp_parity off its plain run: {rec}")
        if not rec["dygraph_ranks_equal"]:
            bad.append("dp_parity: dygraph parameters differ across ranks")
        sb = r0["sync_bn_bf16"]
        rec["sync_bn_bf16"] = {k: v for k, v in sb.items() if k != "digest"}
        if any(r["sync_bn_bf16"]["digest"] != sb["digest"] for r in ranks):
            bad.append("dp_parity: the bf16 ResNet-50 step's parameters "
                       "differ across ranks")
        # one bf16 step's parameter updates are far from float32's at
        # random init (plain_vs_fp32 reads them), so they are read, not
        # held; the ops are held to float32, and the step's running
        # statistics (a forward's) to the plain step's
        stats = ("bn_mean", "bn_variance")
        if sb["sync_batch_norm_ops"] != sb["tensors"]["bn_scale"] or max(
                sb["update_rel_l2"][g] for g in stats) > sb["limit"]:
            bad.append(f"dp_parity: the bf16 sync_batch_norm step is off "
                       f"the plain batch_norm step: {rec['sync_bn_bf16']}")
        for r in ranks:
            for row in r["sync_bn_bf16"]["ops"]:
                if max(row["sync_batch_norm"].values()) > sb["op_limit"]:
                    bad.append(f"dp_parity: rank {r['rank']}'s bf16 "
                               f"sync_batch_norm op is off float32: {row}")
    else:
        slow = max(ranks, key=lambda r: r["run_steps_ms_per_step"])
        per_card = ((r0["B"] / slow["run_steps_ms_per_step"]) * 1e3)
        rec.update({k: r0.get(k) for k in (
            "B", "S", "P", "image", "depth", "layers", "K",
            "sync_batch_norm_ops", "allreduce_buckets", "slab_losses",
            "slab2_losses", "eager_losses",
            "launches_per_step_run_steps",
            "bf16_launches_per_step_run_steps")})
        rec.update({
            "run_steps_ms_per_step": slow["run_steps_ms_per_step"],
            "eager_ms_per_step": max(r["eager_ms_per_step_median"]
                                     for r in ranks),
            "capture_s": max(r["capture_s"] for r in ranks),
            "first_slab_ms_with_capture": max(
                r["first_slab_ms_with_capture"] for r in ranks),
            "samples_per_s_per_card": per_card,
            "samples_per_s_total": per_card * nproc,
            "achieved_tflops_per_card": r0["analytic_flops_per_step"]
            / slow["run_steps_ms_per_step"] / 1e9})
        if "S" in r0:
            rec["tokens_per_s_per_card"] = per_card * r0["S"]
            rec["tokens_per_s_total"] = per_card * r0["S"] * nproc
        if "profile" in r0:
            # one rank's profiled slab, read together: the rank whose
            # profiled slab took longest
            split = nccl_wait_split([r["profile"] for r in ranks])
            prof = max(ranks, key=lambda r: r["profile"]["wall_ms"])
            pr, K = prof["profile"], r0["K"]
            rec.update({
                "profiled_rank": prof["rank"],
                "profiled_wall_ms_per_step": pr["wall_ms"] / K,
                "device_busy_ms_per_step": pr["busy_ms"] / K,
                "idle_share": 1.0 - pr["busy_ms"] / pr["wall_ms"],
                "kernel_sum_ms_per_step": pr["kernel_sum_ms"] / K,
                "compute_busy_ms_per_step": pr["compute_busy_ms"] / K,
                "nccl_device_ms_per_step": sum(pr["nccl_us"]) / 1e3 / K,
                "nccl_busy_ms_per_step": pr["nccl_busy_ms"] / K,
                "nccl_kernels_per_step": len(pr["nccl_us"]) / K,
                "nccl_transfer_ms_per_step":
                    None if split is None else split[prof["rank"]][0] / K,
                "nccl_wait_ms_per_step":
                    None if split is None else split[prof["rank"]][1] / K,
                "nccl_wait_ms_per_step_by_rank":
                    None if split is None else [w / K for _, w in split],
                "eager_op_device_ms": prof.get("eager_op_device_ms"),
                "peak_mem_gb": max(r["peak_mem_gb"] for r in ranks)})
        # the loss falling: each rank's batch 0 again at step 2, after
        # two updates, below its step 0 (lr 0.1 without warm-up swings
        # the later steps of two random-label batches)
        if name == "dp_resnet50" and not all(
                r["eager_losses"][2] < r["eager_losses"][0]
                for r in ranks):
            bad.append(f"{name}: the loss is not falling: "
                       f"{[r['eager_losses'] for r in ranks]}")
        cuda = not (args or {}).get("cpu")
        if nproc > 1 and cuda and \
                not all(r.get("nccl_kernels_per_step") for r in ranks):
            bad.append(f"{name}: no NCCL kernel in the replay's trace")
        if name == "fleet_bert" and cuda:
            want = {w: (r0["layers"] if w in DP_BERT_KERNELS else 0)
                    for w in r0["launches_per_step_run_steps"]}
            for r in ranks:
                got = r["launches_per_step_run_steps"]
                bf = r["bf16_launches_per_step_run_steps"]
                if got != want or any(bf[w] != got[w]
                                      for w in DP_BERT_KERNELS):
                    bad.append(f"fleet_bert rank {r['rank']} launched "
                               f"{got} a step (bf16 {bf}), not {want}")
    rec["ranks_equal"] = not any("across ranks" in b for b in bad)
    rec["launches_by_rank"] = [r["launches"] for r in ranks]
    rec["bf16_launches_by_rank"] = [r["bf16_launches"] for r in ranks]
    rec["ok"] = not bad
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError(f"{name} at N={nproc}: {bad}")
    return rec


def dp_phases(torch, np, counters, name, n=None, args=None, at_one=True):
    """Data-parallel phase ``name`` at N = n (default: every card), and,
    for dp_resnet50 and fleet_bert when N > 1 and ``at_one``, at N = 1
    too with the scaling line. Adds the ranks' kernel launches to ``counters`` (the
    parent's wrappers, by name), as the drive of a main path reads them.
    Returns {N: record}."""
    n = n or torch.cuda.device_count()
    args = args or {}
    out = {}
    for k in [n] if name == "dp_parity" or n == 1 or not at_one \
            else [1, n]:
        a = dict(args.get(name, {}))
        if args.get("cpu"):
            a["cpu"] = True
        elif n == 1 and name == "fleet_bert":
            a.setdefault("layers", ONE_CARD_LAYERS["fleet_bert"])
        a.setdefault("run", {"dp_resnet50": DP_RESNET,
                             "fleet_bert": DP_BERT}.get(name, {}))
        out[k] = rec = dp_phase(torch, np, name, k, a)
        for r in rec["ranks"]:
            for w, c in r["launches"].items():
                cw = counters.get(w)
                if cw is not None:
                    cw.launches += c
                    if hasattr(cw, "bf16_launches"):
                        cw.bf16_launches += r["bf16_launches"].get(w, 0)
    if n > 1 and 1 in out:
        one, many = out[1], out[n]
        emit({"phase": f"{name}_scaling", **CARD, "N": n,
              "samples_per_s_total_N": many["samples_per_s_total"],
              "samples_per_s_at_1": one["samples_per_s_total"],
              "scaling": many["samples_per_s_total"]
              / (n * one["samples_per_s_total"]),
              "ms_per_step_N": many["run_steps_ms_per_step"],
              "ms_per_step_1": one["run_steps_ms_per_step"]})
    return out

# ------------------------------------------------ tensor parallelism

# tp_parity: a narrow BERT in float32 (flash: K1/K2 at its 8 heads over
# tp), 3 Adam steps on every rank's rows of one seeded global batch
TP_PARITY = {"cfg": {"vocab_size": 1024, "hidden_size": 256,
                     "num_layers": 2, "num_heads": 8, "ffn_size": 1024,
                     "max_position": 512},
             "B": 8, "S": 128, "P": 8, "steps": 3}
# tp_bert: bench_bert_long's step (fleet_bert's, global B16) over dp x tp
TP_BERT = dict(DP_BERT)
# tp_generate: GPT-base, paged fp32, 8 rows of 128-token prompts
TP_GEN = {"rows": 8, "prompt": 128, "new": 128, "short": 8,
          "max_len": 512, "seed": 0}
# the ops of a tp_bert step that launch an NCCL kernel each
TP_NCCL_OPS = ("c_identity_grad", "mp_allreduce_sum", "c_concat",
               "c_coalesced_allreduce_sum")


def tp_grid(n, phase):
    """(dp, tp) of a tp phase on ``n`` cards: tp_generate and tp_serving
    at tp n, the training phases at dp 2 x tp 2 on 4 cards (tp n
    below)."""
    if phase not in ("tp_generate", "tp_serving") and n >= 4 \
            and n % 2 == 0:
        return n // 2, 2
    return 1, n


def _tp_world(args):
    from paddle_tpu_torch.parallel import mesh
    return mesh.make_mesh(mesh.MeshConfig(dp=args["dp"], tp=args["tp"]))


def _tp_rows(feed, d, b, S, P):
    """dp coordinate ``d``'s ``b`` sequences of a BERT batch (its
    ``mask_pos`` re-based on its first sequence)."""
    out = {k: feed[k][d * b:(d + 1) * b]
           for k in ("src_ids", "sent_ids", "pos_ids", "input_mask",
                     "labels")}
    G = feed["src_ids"].shape[0]
    pos = feed["mask_pos"].reshape(G, P)[d * b:(d + 1) * b]
    out["mask_pos"] = (pos - d * b * S).reshape(-1)
    out["mask_label"] = feed["mask_label"][d * b * P:(d + 1) * b * P]
    return out


def _tp_digests(torch, scope, names, split):
    """(digest of the replicated state, digest of all of it) of this
    rank's ``names`` in ``scope`` (``split``: the tp-split names)."""
    items = [(n, scope.find_var(n)) for n in names]
    return (_state_digest(torch, [kv for kv in items if kv[0] not in split]),
            _state_digest(torch, items))


def _tp_parity(torch, np, args, rank, n, place):
    """The contract at small width, float32: a narrow BERT (flash)
    annotated by ``bert.apply_tp_sharding``, 3 Adam steps through
    ``with_data_parallel(mesh=make_mesh(dp, tp))`` on this rank's rows of
    a seeded global batch, eagerly and by a run_steps slab from copies of
    one startup scope; a save of the tp state; rank 0 also runs the
    plain program on the whole batch on its card from that startup and
    loads the save on one card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.tp import gathered
    p = args["run"]
    grid = _tp_world(args)
    d = grid.coords()["dp"]
    G, S, P = p["B"], p["S"], p["P"]
    b = G // args["dp"]
    cfg = bert.BertConfig(**p["cfg"], hidden_dropout=0.0, attn_dropout=0.0,
                          attn_mechanism="flash")

    def build(rows, annotate):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 11
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = bert.bert_pretrain(cfg, rows, S, P)
            if annotate:
                bert.apply_tp_sharding(main, cfg)
            fluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
        return main, startup, out["loss"]

    feeds = [bert.random_batch(cfg, G, S, P,
                               rng=np.random.default_rng(300 + i))
             for i in range(p["steps"])]
    mine = [_tp_rows(f, d, b, S, P) for f in feeds]
    main, startup, loss = build(b, True)
    exe = fluid.Executor(place)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    sA, sB = (copied_scope(torch, fluid, s0) for _ in range(2))
    eager = [exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
             for f in mine]
    slab = exe.run_steps(comp, feed=mine, fetch_list=[loss], scope=sB)[0]
    diff = scope_diff(torch, sA, sB)
    names = [v.name for v in main.list_vars() if v.persistable
             and isinstance(sA.find_var(v.name), torch.Tensor)]
    split = set(comp._tp_layouts)
    rep, full = _tp_digests(torch, sA, names, split)
    params = [q.name for q in main.all_parameters()]
    with gathered(sA):
        whole = {q: sA.find_var(q).detach().clone() for q in params}
    ckpt = os.path.join(DP_DIR, f"tp_parity_ckpt.n{n}")
    fluid.io.save_persistables(exe, ckpt, main_program=main, scope=sA)
    rec = {"losses": [float(np.ravel(v)[0]) for v in eager],
           "slab_losses": [float(v) for v in np.ravel(slab)],
           "slab_bitwise": bool(np.array_equal(
               np.stack(eager).reshape(-1), np.ravel(slab))) and not diff,
           "scope_diff": diff[:8], "coords": grid.coords(),
           "dp": args["dp"], "tp": args["tp"],
           "digest_replicated": rep, "digest": full,
           "split": sorted(split),
           "report": getattr(comp.program, "_tp_report", {}),
           "qkv_local": list(sA.find_var(
               "encoder_layer_0_multi_head_att_qkv.w_0").shape)}
    if rank == 0:
        pmain, pstart, ploss = build(G, False)
        sp = copied_scope(torch, fluid, s0)
        plain = [exe.run(pmain, feed=f, fetch_list=[ploss], scope=sp)[0]
                 for f in feeds]
        top = max(float(sp.find_var(q).abs().max()) for q in params)
        errs = {q: float((whole[q].float() - sp.find_var(q).float())
                         .abs().max()) for q in params}
        rec.update({"plain_losses": [float(np.ravel(v)[0]) for v in plain],
                    "max_err_of_model_max": max(errs.values()) / top,
                    "max_rel_err": max(_rel_err(
                        np, whole[q].cpu().numpy(),
                        sp.find_var(q).cpu().numpy()) for q in params),
                    "worst": max(errs, key=errs.get)})
        sl = fluid.Scope()
        exe.run(pstart, scope=sl)
        fluid.io.load_persistables(exe, ckpt, main_program=pmain, scope=sl)
        rec["reload_equal"] = all(
            torch.equal(sl.find_var(q), whole[q].to(sl.find_var(q).device))
            for q in params)
    _release(torch, exe)
    return rec


def _tp_bert(torch, np, args, rank, n, place):
    """BERT-base at bench_bert_long's shape (flash, bf16 AMP, Adam at
    noam_decay, dropout 0) annotated by ``bert.apply_tp_sharding``
    through ``with_data_parallel(mesh=make_mesh(dp, tp))``: fleet_bert's
    global batch (16 rows seeded 200) split over dp, K eager steps and
    run_steps slabs (:func:`_dp_train`); rank 0 then runs fleet_bert's
    program at N = 1 (the plain one) for step 0 from the same startup."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    run = args["run"]
    grid = _tp_world(args)
    d = grid.coords()["dp"]
    G, S, P = run["B"], run["S"], run["P"]
    b = G // args["dp"]
    cfg = bert_config(args.get("layers"), "flash", dropout=0.0,
                      max_position=max(S, 512))

    def build(rows, annotate):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = bert.bert_pretrain(cfg, rows, S, P)
            if annotate:
                bert.apply_tp_sharding(main, cfg)
            lr = fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0)
            mp.decorate(fluid.optimizer.AdamOptimizer(lr),
                        init_loss_scaling=1.0,
                        use_dynamic_loss_scaling=False).minimize(out["loss"])
        return main, startup, out["loss"]

    glob = bert.random_batch(cfg, G, S, P, rng=np.random.default_rng(200))
    main, startup, loss = build(b, True)
    exe = fluid.Executor(place)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(exe.device)
             for k, v in _tp_rows(glob, d, b, S, P).items()}]
    rec = _dp_train(torch, np, fluid, exe, comp, startup, loss, pool,
                    run["K"], TP_NCCL_OPS)
    ops = comp.program.global_block().ops
    flash = next(o for o in ops if o.type == "flash_attention")
    rec.update({"B": G, "rows": b, "S": S, "P": P,
                "layers": cfg.num_layers, "dp": args["dp"],
                "tp": args["tp"], "coords": grid.coords(),
                "heads_a_rank": comp.program.global_block().var(
                    flash.input("Q")[0]).shape[1],
                "report": getattr(comp.program, "_tp_report", {}),
                "collective_axes": [
                    "dp" if o.type == "c_coalesced_allreduce_sum" else "tp"
                    for o in ops if o.type in TP_NCCL_OPS],
                "analytic_flops_per_step":
                    bert_train_flops_per_sample(cfg, S, P) * G})
    split = set(comp._tp_layouts)
    rec["digest_replicated"] = {k: v for k, v in rec["digest"].items()
                                if k not in split}
    _release(torch, exe)
    if rank == 0:
        pmain, pstart, ploss = build(G, False)
        exe = fluid.Executor(place)
        sp = fluid.Scope()
        exe.run(pstart, scope=sp)
        feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(exe.device)
                for k, v in glob.items()}
        rec["plain_step0_loss"] = float(np.ravel(exe.run(
            pmain, feed=feed, fetch_list=[ploss], scope=sp)[0])[0])
        del sp
        _release(torch, exe)
    return rec


def _tp_generate(torch, np, args, rank, n, place):
    """GPT-base (seeded weights) generated at tp = every rank
    (``GPTGenerator(tp=)``, paged fp32) beside tp = 1 on this rank's
    card: tokens, prefill logits, launches by replay, a profiled replay,
    the wire bytes a step against the gate's budget, tokens/s (at tp 1
    timed on one rank at a time)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    g = args["run"]
    cfg = GPTConfig.base() if not args.get("tiny") else GPTConfig.tiny()
    if args.get("layers"):
        cfg.num_layers = args["layers"]
    device = "cpu" if place is not None else None
    params = init_params(cfg, g["seed"])
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, cfg.vocab_size, g["prompt"]).astype(np.int32)
               for _ in range(g["rows"])]
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    cuda = place is None
    rec = {"tp": args["tp"], "rows": g["rows"], "prompt": g["prompt"],
           "new": g["new"], "layers": cfg.num_layers}
    from paddle_tpu_torch.parallel import mesh
    out, gens = {}, {}
    for tp in (1, args["tp"]) if args["tp"] > 1 else (1,):
        gen = gens[tp] = GPTGenerator(cfg, params, max_len=g["max_len"],
                                      device=device, tp=tp)
        toks = gen.generate(prompts, max_new_tokens=g["new"], paged=True)
        # tp 1 is timed one rank at a time (the others wait at a
        # barrier), so its reading is one generator's, not four sharing
        # the host; tp > 1 runs on every rank at once, as it must. Each
        # reading is the median of ``reps`` calls
        reps = g.get("reps", 5)
        for turn in range(n) if tp == 1 else (rank,):
            if turn == rank:
                k1 = fa.flash_attention_fwd.launches
                k5 = pa.paged_attention.launches
                fulls = [_timed_wall(torch, cuda, lambda: gen.generate(
                    prompts, max_new_tokens=g["new"], paged=True))[1]
                    for _ in range(reps)]
                k1 = (fa.flash_attention_fwd.launches - k1) / reps
                k5 = (pa.paged_attention.launches - k5) / reps
                shorts = [_timed_wall(torch, cuda, lambda: gen.generate(
                    prompts, max_new_tokens=g["short"], paged=True))[1]
                    for _ in range(reps)]
                secs, short = float(np.median(fulls)), \
                    float(np.median(shorts))
            if tp == 1:
                mesh.barrier()
        steps = g["new"] - 1
        tokens, pos_ids, last = gen._pack_prompts(prompts)
        logits, _, _ = gen.run_prefill(tokens, pos_ids, last)
        out[tp] = {"tokens": [t.tolist() for t in toks],
                   "logits": logits.float().cpu()}
        rec[f"tp{tp}"] = {
            "tokens_per_sec": g["rows"] * g["new"] / (secs / 1e3),
            "generate_ms": fulls, "short_ms": shorts, "reps": reps,
            "ms_per_token": secs / g["new"],
            "decode_ms_per_step": (secs - short) / (g["new"] - g["short"]),
            "k1_per_prefill": k1, "k5_per_decode_step": k5 / steps,
            "weight_bytes_a_card": sum(
                t.numel() * t.element_size()
                for t in gen.param_tensors().values()),
            # what the gate read on each kind's first run
            "wire_bytes_decode_step": gen.wire_bytes.get("decode_paged", 0),
            "wire_budget_decode_step": gen._tp_wire_budget(g["rows"],
                                                           g["rows"]),
            "wire_bytes_prefill": gen.wire_bytes.get("prefill", 0),
            "wire_budget_prefill": gen._tp_wire_budget(
                g["rows"] * tokens.shape[1], g["rows"]),
            "heads_a_rank": gen.model.heads}
    tp = args["tp"]
    if tp > 1:
        one, many = out[1], out[tp]
        ref = one["logits"]
        rec["tokens_equal"] = one["tokens"] == many["tokens"]
        rec["prefill_logits_err"] = float(
            (many["logits"] - ref).abs().max() / ref.abs().max())
        rec["speedup_vs_1"] = rec[f"tp{tp}"]["tokens_per_sec"] \
            / rec["tp1"]["tokens_per_sec"]
    if cuda:
        gen = gens[tp]
        rows = g["rows"]
        pool = gen._pool(rows, None)
        for r in range(rows):
            pool.alloc(r, g["prompt"] + 2)
        tok = np.ones(rows, np.int32)
        pos = np.full(rows, g["prompt"], np.int32)
        gen.decode(tok, pos, np.zeros(rows, np.float32),
                   np.zeros(rows, np.int32), pool)
        _, names = profiled_trace(torch, lambda: gen.decode(
            tok, pos, np.zeros(rows, np.float32), np.zeros(rows, np.int32),
            pool))
        for r in range(rows):
            pool.free_slot(r)
        rec["replay_nccl_kernels"] = sum(c for k, c in names.items()
                                         if "nccl" in k.lower())
        rec["replay_k5"] = sum(c for k, c in names.items()
                               if "paged" in k.lower())
    for gen in gens.values():
        gen.release()
    del gens
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec["kernels_counted"] = {w.__name__: w.launches
                              for w in kernels.COUNTED}
    return rec


# tp_serving: GPT-base served over the wire by InferenceServer(generator=
# GPTGenerator(tp=N)) on the launched ranks, paged fp32, 8 slots
TP_SERVE = {"slots": 8, "max_len": 2048, "lo": 64, "hi": 1024, "new": 64,
            "main": 16, "clients": 4, "chunk": 256, "spec_k": 4,
            "spec_prompts": (128, 256), "cancel_new": 512,
            "profile_prompt": 128, "profile_new": 16, "prefix_prompt": 320,
            "seed": 0, "seed_b": 1}
TPS_DIR = os.path.join(ROOT, "build", "chip_smoke_tp_serving")


def _counting(obj, name, box):
    """``obj.name`` replaced on the instance by a wrapper that counts its
    calls into ``box[name]``."""
    fn = getattr(obj, name)

    def counted(*a, **kw):
        box[name] = box.get(name, 0) + 1
        return fn(*a, **kw)
    setattr(obj, name, counted)


def _hist_mean_ms(hist, before):
    _, count, total, _ = hist._state()
    n, t = count - before[1], total - before[2]
    return t / n * 1e3 if n else None


def _repeating_prompt(np, cfg, n, seed):
    """``n`` tokens of a seeded 16-token motif repeated: an n-gram
    drafter's proposals are accepted on it."""
    motif = np.random.default_rng(seed).integers(1, cfg.vocab_size, 16)
    return np.resize(motif, n).astype(np.int32)


def _tp_serving(torch, np, args, rank, n, place):
    """GPT-base (seeded weights A, and B written by ``io.save_params``)
    served over the wire at tp = every rank: every rank builds
    ``InferenceServer(generator=GPTGenerator(tp=N), decode_slots=8,
    paged=True)``; the leader (rank 0) binds the port and drives it from
    4 client threads, each follower runs the loop (``serving.tp``).
    Traffic, in groups: 16 requests of ``pr1_prompts`` lengths 64-1024
    (timed: tokens/s, decode ms a step, the hand-off a step), two
    chunked prefills (``prefill_chunk_tokens`` 256), two n-gram
    speculative requests (k 4), one request cancelled mid-decode, one
    prefill-only request whose KV payload is kept, a profiled window
    (16 tokens; every rank traces its own device), a hot reload to B
    with 4 requests in flight and 4 after it, ``drain``; then a server
    with the prefix cache (weights B) serving one prompt twice (a prefix
    hit), ``drain``. The pools' digests are read after every group. The
    leader then holds every completed request to ``GPTGenerator(tp=1)
    .generate`` over its weights on its card, and imports the payload
    into a tp 1 ``GenerationEngine`` to continue it."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    from paddle_tpu_torch.serving import (Client, GenerationEngine,
                                          GenerationRequest, InferenceServer,
                                          RequestCancelledError)
    from paddle_tpu_torch.serving.batching import DecodeBatcher, RequestQueue
    g = args["run"]
    tp = args["tp"]
    cfg = GPTConfig.tiny() if args.get("tiny") else GPTConfig.base()
    L = cfg.num_layers
    device = "cpu" if place is not None else None
    cuda = place is None
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    k1, k5 = fa.flash_attention_fwd, pa.paged_attention
    leader = rank == 0
    coord = dist.new_group(backend="gloo") if n > 1 else None

    def barrier():
        if coord is not None:
            dist.barrier(group=coord)
    params_a = init_params(cfg, g["seed"])
    params_b = init_params(cfg, g["seed_b"])
    ckpt_b = os.path.join(TPS_DIR, "weights_b")
    if leader:
        import shutil
        shutil.rmtree(TPS_DIR, ignore_errors=True)
    barrier()
    _save_gpt_params(np, cfg, params_b, ckpt_b)     # rank 0 writes
    gen = GPTGenerator(cfg, params_a, max_len=g["max_len"], device=device,
                       tp=tp)
    rec = {"tp": tp, "layers": L, "heads": cfg.num_heads,
           "slots": g["slots"], "new": g["new"],
           "weight_bytes_a_card": sum(
               t.numel() * t.element_size()
               for t in gen.param_tensors().values())}
    c0 = (k1.launches, k5.launches)

    def server():
        return InferenceServer(generator=gen, decode_slots=g["slots"],
                               paged=True)

    def window(fn):
        """The profiled window every rank enters together."""
        barrier()
        if not cuda:
            out = fn()
            barrier()
            return out, {}
        _, names = profiled_trace(torch, lambda: (
            trace_markers(torch, True), fn(), barrier()))
        return None, names

    if not leader:
        srv = server()
        srv.start()
        _, names = window(lambda: None)
        err = srv.join()
        rec["follower_a"] = srv.tp_follower.record()
        fluid.set_flags({"FLAGS_kv_prefix_cache": True})
        srv2 = server()
        fluid.set_flags({"FLAGS_kv_prefix_cache": False})
        srv2.start()
        err2 = srv2.join()
        rec["follower_b"] = srv2.tp_follower.record()
        rec["errors"] = [None if e is None else repr(e) for e in (err, err2)]
        rec["calls"] = {k: rec["follower_a"]["calls"].get(k, 0)
                        + rec["follower_b"]["calls"].get(k, 0)
                        for k in ("admit", "step")}
        rec["captures"] = sum(x.tp_follower.engine.decoder.captures
                              for x in (srv, srv2))
    else:
        srv = server().start()
        eng = srv.gen_engine
        calls = {}
        for m in ("admit", "step"):
            _counting(eng, m, calls)
        ep = srv.endpoint
        digests = []

        def check_digests(tag, server):
            if tp > 1:
                digests.append([tag] + server.tp_pool_digests())
        served = {}            # key -> (prompt, weights, tokens or error)

        def wire(jobs, weights):
            """``jobs`` [(key, prompt, new)] from the client threads, each
            thread a connection taking every ``clients``-th job."""
            def worker(mine):
                with Client(ep, timeout=600) as cl:
                    for key, p, new in mine:
                        try:
                            served[key] = (p, weights, cl.generate(p, new))
                        except Exception as e:  # noqa: BLE001 — judged below
                            served[key] = (p, weights, e)
            k = g["clients"]
            threads = [threading.Thread(target=worker, args=(jobs[i::k],))
                       for i in range(k)]
            for t in threads:
                t.start()
            return threads

        def join(threads):
            for t in threads:
                t.join(600)
            if any(t.is_alive() for t in threads):
                raise AssertionError("tp_serving: wire clients hung")

        # 1. the timed group
        prompts = pr1_prompts(np, cfg, g["lo"], g["hi"], g["main"],
                              seed=g["seed"])
        hist = srv.stats_sink.hist["token"]
        h0 = hist._state()
        hand0 = (getattr(eng, "handoff_s", 0.0), getattr(eng, "handoffs", 0))
        t0 = time.perf_counter()
        join(wire([(f"main{i}", p, g["new"]) for i, p in enumerate(prompts)],
                  "a"))
        wall = time.perf_counter() - t0
        gen_tokens = sum(len(v[2]) for k, v in served.items()
                         if k.startswith("main") and not isinstance(
                             v[2], Exception))
        rec["served_tokens_per_s"] = gen_tokens / wall
        rec["main_wall_s"] = wall
        rec["decode_ms_per_step"] = _hist_mean_ms(hist, h0)
        if tp > 1:
            dh = eng.handoffs - hand0[1]
            rec["handoff_us_per_step"] = (eng.handoff_s - hand0[0]) / dh \
                * 1e6 if dh else None
        check_digests("main", srv)
        # 2. two chunked prefills
        fluid.set_flags({"FLAGS_prefill_chunk_tokens": g["chunk"]})
        long_ps = pr1_prompts(np, cfg, g["hi"] // 2, g["hi"], 2,
                              seed=g["seed"] + 1)
        join(wire([(f"chunk{i}", p, g["new"])
                   for i, p in enumerate(long_ps)], "a"))
        fluid.set_flags({"FLAGS_prefill_chunk_tokens": 0})
        check_digests("chunked", srv)
        # 3. two n-gram speculative requests
        srv.decode_batcher.spec_k = g["spec_k"]
        spec_ps = [_repeating_prompt(np, cfg, m, g["seed"] + 2 + m)
                   for m in g["spec_prompts"]]
        join(wire([(f"spec{i}", p, g["new"])
                   for i, p in enumerate(spec_ps)], "a"))
        rec["spec"] = srv.decode_batcher.spec_snapshot()
        srv.decode_batcher.spec_k = 0
        check_digests("spec", srv)
        # 4. one request cancelled mid-decode
        cp = pr1_prompts(np, cfg, g["lo"], g["lo"], 1, seed=g["seed"] + 5)[0]
        box = {}

        def cancelled():
            try:
                with Client(ep, timeout=600) as cl:
                    box["out"] = cl.generate(cp, g["cancel_new"],
                                             rid="tp-cancel")
            except Exception as e:  # noqa: BLE001 — judged below
                box["out"] = e
        t = threading.Thread(target=cancelled)
        t.start()
        _until(lambda: srv.health().get("decode_active_rows", 0) >= 1,
               timeout=120)
        with Client(ep) as cl:
            rec["cancelled"] = cl.cancel("tp-cancel")
        join([t])
        rec["cancel_error"] = type(box.get("out")).__name__
        check_digests("cancel", srv)
        # 5. a prefill-only request: its payload is imported on one card
        xp = pr1_prompts(np, cfg, g["hi"] // 4, g["hi"] // 4, 1,
                         seed=g["seed"] + 6)[0]
        with Client(ep, timeout=600) as cl:
            payload = cl.prefill(xp, g["new"])
        rec["export_heads"] = int(payload["num_heads"])
        check_digests("export", srv)
        # 6. the profiled window: 16 tokens served, every rank tracing
        pp = pr1_prompts(np, cfg, g["profile_prompt"], g["profile_prompt"],
                         1, seed=g["seed"] + 7)[0]
        _, names = window(lambda: join(wire(
            [("profiled", pp, g["profile_new"])], "a")))
        # 7. a hot reload to B with 4 requests in flight, then 4 more
        rp = pr1_prompts(np, cfg, g["lo"], g["hi"] // 2, 8,
                         seed=g["seed"] + 8)
        threads = wire([(f"inflight{i}", p, g["new"])
                        for i, p in enumerate(rp[:4])], "a")
        _until(lambda: srv.health().get("decode_active_rows", 0) >= 4,
               timeout=120)
        rec["reload"] = srv.reload_weights(ckpt_b)
        join(threads)
        join(wire([(f"after{i}", p, g["new"])
                   for i, p in enumerate(rp[4:])], "b"))
        check_digests("reload", srv)
        rec["drain"] = srv.drain(timeout=120)
        rec["blocks_in_use_after_drain"] = eng.pool.blocks_in_use()
        if tp > 1:
            rec["handoffs"] = eng.handoffs
            rec["calls_leader"] = dict(eng.calls)
            rec["broadcasts"] = eng.sends
            rec["broadcast_us_mean"] = eng.send_s / eng.sends * 1e6
            rec["leader_local_ms_per_call"] = {
                k: v / eng.calls[k] * 1e3 for k, v in eng.local_s.items()
                if eng.calls.get(k)}
        # 8. the prefix cache: one prompt twice (weights B)
        fluid.set_flags({"FLAGS_kv_prefix_cache": True})
        srv2 = server()
        fluid.set_flags({"FLAGS_kv_prefix_cache": False})
        srv2.start()
        for m in ("admit", "step"):
            _counting(srv2.gen_engine, m, calls)
        ep = srv2.endpoint
        hp = pr1_prompts(np, cfg, g["prefix_prompt"], g["prefix_prompt"],
                         1, seed=g["seed"] + 9)[0]
        for i in range(2):
            join(wire([(f"prefix{i}", hp, g["new"])], "b"))
        rec["prefix_hits"] = srv2.gen_engine.pool.counters["prefix_hits"]
        check_digests("prefix", srv2)
        rec["drain_prefix"] = srv2.drain(timeout=120)
        rec["blocks_in_use_after_drain_prefix"] = \
            srv2.gen_engine.pool.blocks_in_use()
        rec["calls"] = calls
        # each decode graph's capture runs the step once eagerly first
        rec["captures"] = sum(x.gen_engine.decoder.captures
                              for x in (srv, srv2))
        rec["digests"] = digests
        rec["served"] = len(served)
        rec["failed"] = {k: f"{type(v[2]).__name__}: {v[2]}"
                         for k, v in served.items()
                         if isinstance(v[2], Exception)}
    # launches while serving (the profiled window included), per rank
    rec["k1_launches"] = k1.launches - c0[0]
    rec["k5_launches"] = k5.launches - c0[1]
    rec["replay_nccl_kernels"] = sum(c for k, c in names.items()
                                     if "nccl" in k.lower())
    rec["replay_k5"] = sum(c for k, c in names.items()
                           if "paged" in k.lower())
    gen.release()
    if leader:
        # the references on the leader's card, tp 1, after the traffic
        one = {w: GPTGenerator(cfg, p, max_len=g["max_len"], device=device,
                               tp=1)
               for w, p in (("a", params_a), ("b", params_b))}
        bad, checked = [], 0
        for w in ("a", "b"):
            keys = sorted(k for k, v in served.items() if v[1] == w
                          and not isinstance(v[2], Exception))
            for i in range(0, len(keys), 8):
                ks = keys[i:i + 8]
                news = {len(served[k][2]) for k in ks}
                for new in sorted(news):
                    sub = [k for k in ks if len(served[k][2]) == new]
                    want = one[w].generate([served[k][0] for k in sub],
                                           max_new_tokens=new, paged=True)
                    for k, ref in zip(sub, want):
                        checked += 1
                        if not np.array_equal(np.asarray(served[k][2]),
                                              ref):
                            bad.append(k)
        rec["tokens_checked"] = checked
        rec["tokens_unequal"] = bad
        # the exported slot continues on one card, tp 1
        e1 = GenerationEngine(one["a"], slots=g["slots"], paged=True,
                              pool_name="tp_serving_import")
        b1 = DecodeBatcher(RequestQueue(max_depth=8), e1).start()
        try:
            req = GenerationRequest(xp, max_new_tokens=g["new"], kv=payload,
                                    first_token=payload["first_token"])
            b1.queue.put(req)
            got = req.wait(timeout=600)[0]
        finally:
            b1.stop()
        want = one["a"].generate([xp], max_new_tokens=g["new"],
                                 paged=True)[0]
        rec["import_tp1_equal"] = bool(np.array_equal(got, want))
        for o in one.values():
            o.release()
        del one, e1
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def _tp_failures(name, ranks):
    """What the ranks' records say is wrong: state that should be equal
    and is not (the replicated state across all ranks, all of it across
    the ranks of one tp coordinate), a slab that is not its eager steps,
    a non-finite loss."""
    bad = []
    if name in ("tp_generate", "tp_serving"):
        return bad
    reps = [r["digest_replicated"] for r in ranks]
    if any(x != reps[0] for x in reps[1:]):
        bad.append(f"{name}: the tp-replicated state differs across ranks")
    by_tp = {}
    for r in ranks:
        by_tp.setdefault(r["coords"]["tp"], []).append(r["digest"])
    for j, ds in by_tp.items():
        if any(x != ds[0] for x in ds[1:]):
            bad.append(f"{name}: the state of tp rank {j} differs across "
                       f"the dp ranks")
    for r in ranks:
        if not r.get("slab_bitwise", True):
            bad.append(f"{name}: rank {r['rank']}'s run_steps is not its "
                       f"eager steps ({r.get('scope_diff')})")
        losses = r.get("slab_losses", [])
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: rank {r['rank']} non-finite {losses}")
    return bad


def _tp_serving_failures(rec, ranks, args):
    """tp_serving's record from its ranks' and what is wrong with it:
    tokens that differ from tp 1's, digests that differ, launches that
    are not 12 a prefill and a decode step on some rank, no NCCL kernel
    in a rank's profiled window (tp > 1), an export that does not
    continue on one card, a drain that leaves blocks held, a follower
    that did not end cleanly."""
    bad = []
    r0 = ranks[0]
    t = args["tp"]
    rec.update({k: r0.get(k) for k in (
        "layers", "slots", "new", "served_tokens_per_s", "main_wall_s",
        "decode_ms_per_step", "handoff_us_per_step", "handoffs",
        "weight_bytes_a_card", "served", "tokens_checked", "prefix_hits",
        "reload", "cancelled", "cancel_error", "export_heads",
        "import_tp1_equal", "spec", "drain", "drain_prefix", "digests",
        "calls_leader", "broadcasts", "broadcast_us_mean")})
    rec["leader_local_ms_per_call"] = r0.get("leader_local_ms_per_call")
    # each follower's seconds waiting for the leader and running its
    # calls, and its ms a call by op (the first server)
    rec["followers"] = [{
        "recv_s": r["follower_a"]["recv_s"],
        "handle_s": r["follower_a"]["handle_s"],
        "ms_per_call": {k: v / r["follower_a"]["calls"][k] * 1e3
                        for k, v in r["follower_a"]["op_s"].items()
                        if r["follower_a"]["calls"].get(k)}}
        for r in ranks[1:]]
    rec["per_rank"] = [{k: r.get(k) for k in (
        "rank", "k1_launches", "k5_launches", "calls", "captures",
        "replay_nccl_kernels", "replay_k5", "weight_bytes_a_card")}
        for r in ranks]
    if r0.get("failed"):
        bad.append(f"tp_serving: requests failed: {r0['failed']}")
    if r0["tokens_unequal"] or not r0["tokens_checked"]:
        bad.append(f"tp_serving: {len(r0['tokens_unequal'])} of "
                   f"{r0['tokens_checked']} requests differ from "
                   f"GPTGenerator(tp=1).generate: {r0['tokens_unequal']}")
    for tag, *ds in r0["digests"]:
        if len(set(ds)) != 1:
            bad.append(f"tp_serving: the pools' digests differ after "
                       f"{tag}: {ds}")
    if t > 1 and len(r0["digests"]) < 6:
        bad.append(f"tp_serving: {len(r0['digests'])} digest checks, not 6")
    if not r0["import_tp1_equal"]:
        bad.append("tp_serving: the slot exported at tp "
                   f"{t} does not continue to generate's tokens on one card")
    if r0["export_heads"] != r0["heads"]:
        bad.append(f"tp_serving: the payload holds {r0['export_heads']} "
                   f"heads, not every one")
    if not (r0["cancelled"] and r0["cancel_error"] ==
            "RequestCancelledError"):
        bad.append(f"tp_serving: the cancel gave {r0['cancel_error']}")
    if not r0["prefix_hits"]:
        bad.append("tp_serving: the repeated prompt hit no cached prefix")
    for d in ("drain", "drain_prefix"):
        if not r0[d]["drained"]:
            bad.append(f"tp_serving: {d} left {r0[d]['remaining']}")
    for k in ("blocks_in_use_after_drain",
              "blocks_in_use_after_drain_prefix"):
        if r0[k]:
            bad.append(f"tp_serving: {k} {r0[k]}")
    for r in ranks:
        L = r["layers"]
        admits, steps = r["calls"]["admit"], r["calls"]["step"]
        # a paged decode step: each replay and each capture's eager
        # warm-up
        steps += r["captures"]
        if not args.get("cpu") and (
                r["k1_launches"] != L * admits or not admits
                or r["k5_launches"] != L * steps or not steps):
            bad.append(f"tp_serving: rank {r['rank']} launched K1 "
                       f"{r['k1_launches']} in {admits} prefills and K5 "
                       f"{r['k5_launches']} in {steps} decode steps "
                       f"(captures included), not {L} each")
        if not args.get("cpu") and t > 1 and r["replay_nccl_kernels"] < 1:
            bad.append(f"tp_serving: rank {r['rank']}'s profiled window "
                       f"holds no NCCL kernel")
        if not args.get("cpu") and r["replay_k5"] < 1:
            bad.append(f"tp_serving: rank {r['rank']}'s profiled window "
                       f"holds no K5")
        if r["rank"] and (any(r["errors"]) or r["follower_a"]["error"]
                          or r["follower_b"]["error"]):
            bad.append(f"tp_serving: follower {r['rank']} ended with "
                       f"{r['errors']}")
    beside = args.get("beside")
    if beside:
        rec["tp_generate_beside"] = beside
    return bad


def tp_phase(torch, np, name, nproc, args=None, timeout=900):
    """One tensor-parallel phase at ``nproc`` ranks (one a card), checked
    and printed with the card, its power limit and N. Returns the
    record."""
    args = dict(args or {})
    args["dp"], args["tp"] = tp_grid(nproc, name)
    if nproc == 1 and name == "tp_bert" and not args.get("cpu"):
        # one card measures no tp: fleet_bert's step at 2 layers, through
        # the same code
        args.setdefault("layers", 2)
    args.setdefault("run", {"tp_parity": TP_PARITY, "tp_bert": TP_BERT,
                            "tp_generate": TP_GEN,
                            "tp_serving": TP_SERVE}[name])
    ranks, launch = dp_launch(torch, name, nproc, args, timeout)
    rec = {"phase": name, **CARD, "N": nproc, "dp": args["dp"],
           "tp": args["tp"], "launch": launch}
    bad = _tp_failures(name, ranks)
    r0 = ranks[0]
    if name == "tp_parity":
        rec.update({k: r0[k] for k in (
            "losses", "plain_losses", "max_err_of_model_max",
            "max_rel_err", "worst", "reload_equal", "report", "qkv_local")})
        rec["slab_bitwise"] = all(r["slab_bitwise"] for r in ranks)
        rec["mean_losses"] = np.mean(
            [r["losses"] for r in ranks if r["coords"]["tp"] == 0],
            0).tolist()
        if r0["max_err_of_model_max"] > 1e-4:
            bad.append(f"tp_parity: gathered parameters off the plain run "
                       f"by {r0['max_err_of_model_max']:.3g} of max |ref| "
                       f"({r0['worst']})")
        if not r0["reload_equal"]:
            bad.append("tp_parity: the tp save reloads on one card to "
                       "other values")
    elif name == "tp_bert":
        slow = max(ranks, key=lambda r: r["run_steps_ms_per_step"])
        ms = slow["run_steps_ms_per_step"]
        step0 = float(np.mean([r["eager_losses"][0] for r in ranks
                               if r["coords"]["tp"] == 0]))
        rec.update({k: r0.get(k) for k in (
            "B", "rows", "S", "P", "layers", "K", "heads_a_rank", "report",
            "slab_losses", "launches_per_step_run_steps",
            "bf16_launches_per_step_run_steps", "plain_step0_loss")})
        rec.update({
            "step0_loss": step0,
            "ms_per_step": ms,
            "samples_per_s_total": r0["B"] / ms * 1e3,
            "tokens_per_s_total": r0["B"] * r0["S"] / ms * 1e3,
            "peak_mem_gb_a_card": max(r.get("peak_mem_gb") or 0.0
                                      for r in ranks),
            "nccl_kernels_per_step": r0.get("nccl_kernels_per_step"),
            "capture_s": r0.get("capture_s")})
        if "profile" in slow:
            prof = slow["profile"]
            rec["profile_slowest"] = {k: v for k, v in prof.items()
                                      if k != "nccl_us"}
            # the i-th NCCL kernel of a step is the step's i-th
            # communicating collective op (the program's order)
            axes, us = slow["collective_axes"], prof["nccl_us"]
            K = r0["K"]
            if len(us) == K * len(axes):
                split = {"tp": 0.0, "dp": 0.0}
                for i, u in enumerate(us):
                    split[axes[i % len(axes)]] += u / 1e3 / K
                rec["nccl_ms_a_step_replay"] = split
            rec["idle_share_replay"] = 1 - prof["busy_ms"] / prof["wall_ms"]
        heads = bert_config().num_heads // args["tp"]
        if r0["heads_a_rank"] != heads:
            bad.append(f"tp_bert: {r0['heads_a_rank']} heads a rank, not "
                       f"{heads}")
        for r in ranks if not args.get("cpu") else ():
            per = r["launches_per_step_run_steps"]
            want = r0["layers"]
            if per["flash_attention_fwd"] != want or \
                    per["flash_attention_bwd_single"] != want:
                bad.append(f"tp_bert: rank {r['rank']} launched {per} a "
                           f"step, not K1 and K2 {want} each")
        if abs(step0 - r0["plain_step0_loss"]) > \
                2e-2 * abs(r0["plain_step0_loss"]):
            bad.append(f"tp_bert: step 0's loss {step0} is off fleet_bert's "
                       f"program's {r0['plain_step0_loss']}")
    elif name == "tp_serving":
        bad += _tp_serving_failures(rec, ranks, args)
    else:
        rec.update({k: r0[k] for k in r0 if k.startswith("tp") or k in (
            "tokens_equal", "prefill_logits_err", "speedup_vs_1",
            "replay_nccl_kernels", "replay_k5", "rows", "prompt", "new")})
        # each rank's tp 1 reading, taken alone, and its tp N one; the
        # spread across ranks is (max - min) / median
        t = args["tp"]
        for tag in sorted({"tp1", f"tp{t}"}):
            by = [r[tag]["tokens_per_sec"] for r in ranks]
            rec[f"{tag}_tokens_per_sec_by_rank"] = by
            rec[f"{tag}_spread"] = (max(by) - min(by)) / float(np.median(by))
        for r in ranks:
            one, many = r["tp1"], r[f"tp{t}"]
            layers = r["layers"]
            for tag, row in (("tp 1", one), (f"tp {t}", many)):
                if args.get("cpu"):
                    continue
                if row["k1_per_prefill"] != layers or \
                        row["k5_per_decode_step"] != layers:
                    bad.append(f"tp_generate: rank {r['rank']} at {tag}: K1 "
                               f"{row['k1_per_prefill']} a prefill, K5 "
                               f"{row['k5_per_decode_step']} a decode step, "
                               f"not {layers} each")
            for step in ("decode_step", "prefill"):
                if many[f"wire_bytes_{step}"] > many[f"wire_budget_{step}"]:
                    bad.append(f"tp_generate: rank {r['rank']}'s {step} "
                               f"moves {many[f'wire_bytes_{step}']} bytes")
            if t > 1:
                if not r["tokens_equal"]:
                    bad.append(f"tp_generate: rank {r['rank']}'s tokens at "
                               f"tp {t} differ from tp 1's")
                if r["prefill_logits_err"] > 1e-4:
                    bad.append(f"tp_generate: rank {r['rank']}'s prefill "
                               f"logits off tp 1 by "
                               f"{r['prefill_logits_err']:.3g} of max |ref|")
                if r.get("replay_nccl_kernels", 1) < 1:
                    bad.append(f"tp_generate: rank {r['rank']}'s profiled "
                               f"replay holds no NCCL kernel")
    if args["tp"] == 1:
        rec["note"] = ("one card: tp = 1 through the same code; no tensor "
                       "parallelism was measured")
        print(f"{name}: {rec['note']}", flush=True)
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def tp_phases(torch, np, counters, name, n=None, args=None):
    """Tensor-parallel phase ``name`` at N = n (default: every card); adds
    the ranks' kernel launches to ``counters``."""
    n = n or torch.cuda.device_count()
    args = dict(args or {})
    rec = tp_phase(torch, np, name, n, args)
    for r in rec["ranks"]:
        for w, c in r["launches"].items():
            cw = counters.get(w)
            if cw is not None:
                cw.launches += c
                if hasattr(cw, "bf16_launches"):
                    cw.bf16_launches += r["bf16_launches"].get(w, 0)
    return rec


def tp_kernel_shapes(torch, fa, pa):
    """K1, K2 and K5 against their plain versions at the head counts the
    tp paths give them: K1/K2 at tp_bert's (8 rows, 6 heads, S2048, bf16,
    a key bias), K1 at tp_generate's prefill (8 rows, 3 heads, S128,
    float32, causal), K1 at tp_serving's largest prefill (1 row, 3
    heads, S1024, float32, causal), K5 at their decode step (8 rows, 3
    heads, bs16, pos up to 255, float32)."""
    import numpy as np
    pos = np.linspace(128, 255, 8).round().astype(np.int32)
    out = [flash_phase(torch, fa, 8, 6, 2048, 64, "bfloat16", False, True,
                       seed=2206, packed=False),
           bwd_phase(torch, fa, "flash_attention_bwd_single", 8, 6, 2048, 64,
                     "bfloat16", False, True, seed=2207, packed=False),
           flash_phase(torch, fa, 8, 3, 128, 64, "float32", True, False,
                       seed=2208, packed=True),
           flash_phase(torch, fa, 1, 3, 1024, 64, "float32", True, False,
                       seed=2210, packed=True),
           paged_phase(torch, pa, "tp_decode_H3", 8, 3, 64, 16, 32, pos,
                       "float32", 2209)]
    for r in out:
        r["tp_shape"] = True
    return out


# ------------------------------------------------ sequence parallelism

# sp_parity: tp_parity's narrow BERT in float32 under each attention
# mechanism ("ring_causal": the ring op with causal=True set on the op),
# 3 Adam steps on one seeded global batch
SP_PARITY = {"cfg": dict(TP_PARITY["cfg"]), "B": 4, "S": 128, "P": 8,
             "steps": 3, "lr": 1e-3}
SP_MECHS = (None, "flash", "ring", "ulysses", "ring_causal")
# sp_bert: BERT-base at S = 2048 a card (8192 on four), B2, max_preds
# S/32, dropout 0, float32, Adam at a constant 1e-4; 2 eager steps, then
# run_steps slabs of 3
SP_BERT = {"B": 2, "S_per_card": 2048, "eager": 2, "K": 3, "lr": 1e-4,
           "seed": 500}
SP_BERT_MECHS = ("ring", "ulysses", "flash")
# the losses against the one-card flash run of the same batches: step 0
# is a forward only (the ring's and Ulysses' float32 online softmax
# against K1's tiles: summation order alone); later steps carry Adam's
# first updates, whose sign follows grads that are rounding noise for
# some weights (each such weight moves by up to 2 lr either way)
SP_LOSS_RTOL = {"step0": 1e-4, "later": 2e-3}


def sp_parity_grids(n):
    """The (dp, sp, tp) meshes of sp_parity on ``n`` cards: sp n, and on
    four cards tp 2 x sp 2 too."""
    grids = [{"dp": 1, "sp": n, "tp": 1}]
    if n == 4:
        grids.append({"dp": 1, "sp": 2, "tp": 2})
    return grids


def _sp_world(g):
    from paddle_tpu_torch.parallel import mesh
    return mesh.make_mesh(mesh.MeshConfig(**g))


def _sp_program(fluid, bert, cfg, rows, S, P, lr, sp_shard, tp=False,
                causal=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, rows, S, P, sp_shard=sp_shard)
        if tp:
            bert.apply_tp_sharding(main, cfg)
        fluid.optimizer.AdamOptimizer(lr).minimize(out["loss"])
    if causal:
        # the op and its grad op's record of it
        for op in main.global_block().ops:
            if op.type == "ring_attention":
                op.attrs["causal"] = True
            elif op.type == "ring_attention_grad":
                op.attrs["__fwd_op__"]["attrs"]["causal"] = True
    return main, startup, out["loss"]


def _sp_parity(torch, np, args, rank, n, place):
    """The contract at small width, float32: the narrow BERT with
    ``sp_shard=True`` under each mechanism, 3 Adam steps through
    ``with_data_parallel(mesh=make_mesh(sp=n))`` (and tp 2 x sp 2 on four
    cards), eagerly and by a run_steps slab from copies of one startup
    scope; rank 0 also runs the plain program on its card from that
    startup. Parameters are gathered over tp before the comparison."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.tp import gathered
    p = args["run"]
    B, S, P = p["B"], p["S"], p["P"]
    feeds = [bert.random_batch(bert.BertConfig(**p["cfg"]), B, S, P,
                               rng=np.random.default_rng(310 + i))
             for i in range(p["steps"])]
    rec = {"cases": []}
    exe = fluid.Executor(place)
    for g in sp_parity_grids(n):
        grid = _sp_world(g)
        for mech in SP_MECHS:
            cfg = bert.BertConfig(**p["cfg"], hidden_dropout=0.0,
                                  attn_dropout=0.0,
                                  attn_mechanism=(mech or "").replace(
                                      "_causal", "") or None)
            causal = mech == "ring_causal"
            main, startup, loss = _sp_program(
                fluid, bert, cfg, B, S, P, p["lr"], True, g["tp"] > 1,
                causal)
            comp = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, mesh=grid)
            s0 = fluid.Scope()
            exe.run(startup, scope=s0)
            sA, sB = (copied_scope(torch, fluid, s0) for _ in range(2))
            eager = [exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
                     for f in feeds]
            slab = exe.run_steps(comp, feed=feeds, fetch_list=[loss],
                                 scope=sB)[0]
            diff = scope_diff(torch, sA, sB)
            params = [q.name for q in main.all_parameters()]
            with gathered(sA):
                whole = {q: sA.find_var(q).detach().clone() for q in params}
            case = {"mech": mech or "einsum", **g,
                    "losses": [float(np.ravel(v)[0]) for v in eager],
                    "slab_bitwise": bool(np.array_equal(
                        np.stack(eager).reshape(-1), np.ravel(slab)))
                    and not diff, "scope_diff": diff[:4],
                    "report": getattr(comp.program, "_sp_report", {}),
                    "digest": _state_digest(torch, whole.items())}
            if rank == 0:
                pmain, pstart, ploss = _sp_program(
                    fluid, bert, cfg, B, S, P, p["lr"], False, False,
                    causal)
                sp_ = copied_scope(torch, fluid, s0)
                plain = [exe.run(pmain, feed=f, fetch_list=[ploss],
                                 scope=sp_)[0] for f in feeds]
                top = max(float(sp_.find_var(q).abs().max())
                          for q in params)
                errs = {q: float((whole[q].float() - sp_.find_var(q)
                                  .float()).abs().max()) for q in params}
                case.update({
                    "plain_losses": [float(np.ravel(v)[0]) for v in plain],
                    "max_err_of_model_max": max(errs.values()) / top,
                    "worst": max(errs, key=errs.get)})
                del sp_
            rec["cases"].append(case)
            del s0, sA, sB
            _release(torch, exe)
    return rec


def _sp_bert(torch, np, args, rank, n, place):
    """BERT-base with ``sp_shard=True`` at S = 2048 a card, B2, float32,
    Adam: under each of ring, Ulysses and flash, 2 eager steps, a
    run_steps slab of 3 (captured, the collectives inside), a timed
    slab, a profiled slab; the captured step is freed before the next
    mechanism's. Rank 0 then runs the plain program (flash, one card,
    the whole batch) for the same 5 steps from the same startup."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import bert
    run = args["run"]
    B, K, E = run["B"], run["K"], run["eager"]
    S = run["S_per_card"] * n
    P = S // 32
    cuda = not args.get("cpu")
    grid = _sp_world({"dp": 1, "sp": n, "tp": 1})
    feeds = [bert.random_batch(bert_config(args.get("layers")), B, S, P,
                               rng=np.random.default_rng(run["seed"] + i))
             for i in range(E + K)]
    exe = fluid.Executor(place)
    dev = exe.device
    pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in f.items()} for f in feeds]
    slab = {k: torch.stack([f[k] for f in pool[E:]]) for k in pool[0]}
    rec = {"S": S, "B": B, "P": P, "sp": n, "runs": {}}
    for mech in SP_BERT_MECHS:
        cfg = bert_config(args.get("layers"), mech, dropout=0.0,
                          max_position=S)
        main, startup, loss = _sp_program(fluid, bert, cfg, B, S, P,
                                          run["lr"], True)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        base = _peak_base(torch, cuda)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        eager, wall = [], []
        for f in pool[:E]:
            lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                comp, feed=f, fetch_list=[loss], scope=scope)[0])
            eager.append(float(np.ravel(lv)[0]))
            wall.append(ms)
        (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        before = {w.__name__: w.launches for w in kernels.COUNTED}
        _, slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        per_step = {w.__name__: (w.launches - before[w.__name__]) / K
                    for w in kernels.COUNTED}
        r = {"losses": eager + [float(v) for v in np.ravel(got)],
             "eager_ms": wall, "first_slab_ms_with_capture": cap_ms,
             "ms_per_step": slab_ms / K,
             "tokens_per_s": B * S / (slab_ms / K) * 1e3,
             "launches_per_step_run_steps": per_step,
             "report": getattr(comp.program, "_sp_report", {})}
        if cuda:
            prof = kernel_profile(torch, lambda: exe.run_steps(
                comp, feed=slab, fetch_list=[loss], scope=scope))
            r.update({"nccl_kernels_per_step": len(prof["nccl_us"]) / K,
                      "nccl_ms_per_step": prof["nccl_busy_ms"] / K,
                      "compute_ms_per_step": prof["compute_busy_ms"] / K,
                      "idle_share_replay":
                          1 - prof["busy_ms"] / prof["wall_ms"],
                      "peak_mem_gb": _peak_from(torch, cuda, base)})
        params = [q.name for q in main.all_parameters()]
        r["digest"] = _state_digest(torch, [(q, scope.find_var(q))
                                            for q in params])
        rec["runs"][mech] = r
        del scope
        _release(torch, exe)
    if rank == 0:
        cfg = bert_config(args.get("layers"), "flash", dropout=0.0,
                          max_position=S)
        main, startup, loss = _sp_program(fluid, bert, cfg, B, S, P,
                                          run["lr"], False)
        base = _peak_base(torch, cuda)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        plain, wall = [], []
        for f in pool:
            lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0])
            plain.append(float(np.ravel(lv)[0]))
            wall.append(ms)
        rec["plain"] = {"losses": plain, "eager_ms": wall,
                        "peak_mem_gb": _peak_from(torch, cuda, base)}
        del scope
        _release(torch, exe)
    rec["layers"] = bert_config(args.get("layers")).num_layers
    return rec


def _sp_failures(name, ranks, args):
    bad = []
    if name == "sp_parity":
        for i, case in enumerate(ranks[0]["cases"]):
            tag = f"{case['mech']} at sp {case['sp']} tp {case['tp']}"
            for r in ranks:
                if not r["cases"][i]["slab_bitwise"]:
                    bad.append(f"sp_parity {tag}: rank {r['rank']}'s "
                               f"run_steps is not its eager steps")
                if r["cases"][i]["digest"] != case["digest"]:
                    bad.append(f"sp_parity {tag}: rank {r['rank']}'s "
                               f"gathered parameters differ from rank 0's")
            if case["max_err_of_model_max"] > 1e-4:
                bad.append(f"sp_parity {tag}: parameters off the plain run "
                           f"by {case['max_err_of_model_max']:.3g} of max "
                           f"|ref| ({case['worst']})")
        return bad
    from paddle_tpu_torch.kernels.flash_attention import \
        single_pass_backward
    r0 = ranks[0]
    plain = r0["plain"]["losses"]
    L = r0["layers"]
    single = single_pass_backward(r0["S"], False)
    for mech in SP_BERT_MECHS:
        mine = r0["runs"][mech]["losses"]
        for i, (a, b) in enumerate(zip(mine, plain)):
            tol = SP_LOSS_RTOL["step0" if i == 0 else "later"]
            if not math.isfinite(a) or abs(a - b) > tol * abs(b):
                bad.append(f"sp_bert {mech}: step {i}'s loss {a} is off the "
                           f"one-card run's {b} (rtol {tol})")
        for r in ranks:
            if r["runs"][mech]["digest"] != r0["runs"][mech]["digest"]:
                bad.append(f"sp_bert {mech}: rank {r['rank']}'s parameters "
                           f"differ from rank 0's")
            if args.get("cpu"):
                continue
            per = r["runs"][mech]["launches_per_step_run_steps"]
            want = {"flash_attention_fwd": 0, "flash_attention_bwd_single": 0,
                    "flash_attention_bwd_dq": 0,
                    "flash_attention_bwd_dkv": 0, "paged_attention": 0}
            if mech == "flash":
                want["flash_attention_fwd"] = L
                for k in (("flash_attention_bwd_single",) if single else
                          ("flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")):
                    want[k] = L
            if {k: per.get(k, 0) for k in want} != want:
                bad.append(f"sp_bert {mech}: rank {r['rank']} launched "
                           f"{per} a step, not {want}")
    return bad


def sp_phase(torch, np, name, nproc, args=None, timeout=900):
    """One sequence-parallel phase at ``nproc`` ranks (one a card),
    checked and printed with the card, its power limit and N. Returns
    the record."""
    args = dict(args or {})
    if nproc == 1 and name == "sp_bert" and not args.get("cpu"):
        # one card measures no sp: 2 layers through the same code
        args.setdefault("layers", 2)
    args.setdefault("run", {"sp_parity": SP_PARITY,
                            "sp_bert": SP_BERT}[name])
    ranks, launch = dp_launch(torch, name, nproc, args, timeout)
    rec = {"phase": name, **CARD, "N": nproc, "launch": launch}
    bad = _sp_failures(name, ranks, args)
    r0 = ranks[0]
    if name == "sp_parity":
        rec["cases"] = [{k: c.get(k) for k in (
            "mech", "dp", "sp", "tp", "losses", "plain_losses",
            "max_err_of_model_max", "worst", "report")}
            for c in r0["cases"]]
        rec["slab_bitwise"] = all(c["slab_bitwise"] for r in ranks
                                  for c in r["cases"])
    else:
        rec.update({k: r0[k] for k in ("S", "B", "P", "sp", "layers")})
        rec["plain"] = r0["plain"]
        rec["tokens"] = r0["B"] * r0["S"]
        rec["runs"] = {}
        for mech, run in r0["runs"].items():
            slow = max(ranks, key=lambda r: r["runs"][mech]["ms_per_step"])
            row = {k: v for k, v in run.items() if k != "digest"}
            row["ms_per_step_slowest"] = slow["runs"][mech]["ms_per_step"]
            row["tokens_per_s_total"] = r0["B"] * r0["S"] / \
                row["ms_per_step_slowest"] * 1e3
            row["peak_mem_gb_a_card"] = max(
                r["runs"][mech].get("peak_mem_gb") or 0.0 for r in ranks)
            row["launches_per_step_by_rank"] = [
                r["runs"][mech]["launches_per_step_run_steps"]
                for r in ranks]
            rec["runs"][mech] = row
    if nproc == 1:
        rec["note"] = ("one card: sp = 1 through the same code; no "
                       "sequence parallelism was measured")
        print(f"{name}: {rec['note']}", flush=True)
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def sp_phases(torch, np, counters, name, n=None, args=None):
    """Sequence-parallel phase ``name`` at N = n (default: every card);
    adds the ranks' kernel launches to ``counters``."""
    n = n or torch.cuda.device_count()
    rec = sp_phase(torch, np, name, n, args)
    for r in rec["ranks"]:
        for w, c in r["launches"].items():
            cw = counters.get(w)
            if cw is not None:
                cw.launches += c
                if hasattr(cw, "bf16_launches"):
                    cw.bf16_launches += r["bf16_launches"].get(w, 0)
    return rec


def _sp_attention_inputs(torch, B, H, Sq, Sk, D, seed):
    """Seeded q ``[B, H, Sq, D]``, k, v ``[B, H, Sk, D]`` (float32,
    contiguous) and a key bias masking each row's padded tail (a row
    keeps its first Sk/2..Sk keys), as sp_bert's flash op gets them: the
    rank's queries against the gathered keys."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, Sq, D, device="cuda", generator=g)
    k, v = (torch.randn(B, H, Sk, D, device="cuda", generator=g)
            for _ in range(2))
    lens = torch.randint(Sk // 2, Sk + 1, (B, 1, 1, 1), device="cuda",
                         generator=g)
    bias = torch.where(torch.arange(Sk, device="cuda") < lens, 0.0,
                       -1e4).float()
    return q, k, v, bias, g


def sp_kernel_phase(torch, fa, name, B, H, Sq, Sk, D, seed):
    """K1 (``flash_attention_fwd``), K3 or K4 at Sq != Sk (non-causal,
    a key bias, float32) against its plain version on the same inputs
    (limit: 1e-4 of the output's max |ref| for K3/K4, 1e-4 absolute for
    K1), timed by graph replay beside the plain version and SDPA's
    forward or backward with the same mask."""
    F = torch.nn.functional
    q, k, v, bias, g = _sp_attention_inputs(torch, B, H, Sq, Sk, D, seed)
    scale = D ** -0.5
    elem = q.element_size()
    if name == "flash_attention_fwd":
        got = fa.flash_attention_fwd(q, k, v, bias, scale, False)
        ref = fa.flash_attention_ref(q, k, v, bias, scale, False)
        errs = {"out": (got[0] - ref[0]).abs().max().item(),
                "lse2": (got[1] - ref[1]).abs().max().item()}
        ok = errs["out"] <= 1e-4 and errs["lse2"] <= 1e-3
        rel = errs
        del got, ref
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, bias, scale, False), 20)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, bias, scale, False), 3)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias), 20)
        ops = 4.0 * B * H * Sq * Sk * D
        nbytes = (2 * Sq + 2 * Sk) * B * H * D * elem + B * H * Sq * 4 \
            + B * Sk * 4
        replaces = FA_REPLACES
    else:
        replaces, outs, products = BWD_KERNELS[name]
        out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, False)
        dout = torch.randn(B, H, Sq, D, device="cuda", generator=g)
        args = (q, k, v, bias, scale, False, out, lse, dout)
        kern = getattr(fa, name)
        got = kern(*args)
        got = (got,) if len(outs) == 1 else got
        ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(*args)))
        errs, rel = {}, {}
        for o, t in zip(outs, got):
            errs[o] = (t - ref[o]).abs().max().item()
            rel[o] = errs[o] / ref[o].abs().max().item()
        ok = max(rel.values()) <= 1e-4 and all(
            bool(torch.isfinite(t).all()) for t in got)
        del got, ref
        ms = event_ms(torch, lambda: kern(*args), 10)
        plain_ms = event_ms(torch, lambda: fa.flash_attention_bwd_ref(*args),
                            2)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias)
        lib_ms = event_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), dout, retain_graph=True), 10)
        ops = 2.0 * products * B * H * Sq * Sk * D
        sizes = {"dq": Sq, "dk": Sk, "dv": Sk}
        nbytes = (2 * Sq + 2 * Sk + sum(sizes[o] for o in outs)) \
            * B * H * D * elem + 2 * B * H * Sq * 4 + B * Sk * 4
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    rec = {"phase": f"sp_{name}", **CARD, "replaces": replaces, "B": B,
           "H": H, "Sq": Sq, "Sk": Sk, "D": D, "dtype": "float32",
           "causal": False, "bias": "padded", "max_abs_err":
           max(errs.values()), "abs_err": errs, "err": rel, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": ops / ms / 1e9, "ok": ok}
    emit(rec)
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"Sq {Sq} Sk {Sk}: {rec}")
    return rec


def sp_kernel_shapes(torch, fa):
    """K1, K3 and K4 against their plain versions at sp_bert's flash
    shape on four cards (the rank's 2048 queries against the 8192
    gathered keys: B2 H12 D64, float32, non-causal, a padded-tail key
    bias), and at H6 (tp 2 x sp 2)."""
    out = []
    for H in (12, 6):
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            out.append(sp_kernel_phase(torch, fa, name, 2, H, 2048, 8192,
                                       64, seed=2212 + H))
    return out


# ------------------------------------------------ pipeline parallelism

PP_DIR = os.path.join(ROOT, "build", "chip_smoke_pp")
# pp_gpt: GPT-base at bench_gpt_long's shape (B8 S2048), dropout 0,
# float32 (matmuls without TF32), Adam at a constant 1e-4: 2 eager
# steps, then a run_steps slab of 3; its 12 decoder layers in a
# layers.Pipeline
PP_GPT = {"B": 8, "S": 2048, "eager": 2, "K": 3, "lr": 1e-4, "seed": 600}
# the losses against rank 0's one-card run of the same program and
# batches on the sequential path: the same math, summed in another
# order (the dp all-reduce, the microbatches' grads)
PP_LOSS_RTOL = 1e-4
# pp_parity: a narrow GPT, 2 decoder layers a stage, float32, 3 Adam
# steps; every microbatch holds 2 rows
PP_PARITY = {"cfg": {"vocab_size": 1024, "hidden_size": 256,
                     "num_heads": 4, "ffn_size": 1024, "max_position": 128,
                     "dropout": 0.0},
             "B": 8, "S": 128, "layers_a_stage": 2, "micro_rows": 2,
             "steps": 3, "lr": 1e-3}


def pp_grids(n, parity=False):
    """The grids of the pp phases on ``n`` cards: (tag, mesh axes,
    num_stages, pp_gpt's microbatches of a rank's rows). Four cards: pp
    4 (4 stages, M 8), pp 2 x dp 2 (2 stages, 4 rows a rank, M 4) and pp
    2 x tp 2 (2 stages, each run whole by both tp ranks, M 4; the word
    embedding and tied head split on tp), and for ``parity`` pp 2 x sp 2
    too (the pipeline's input split on the sequence, gathered whole
    before it); two: pp 2; one: a 2-stage pipeline on the sequential
    path."""
    grids = {4: [("pp4", {"pp": 4}, 4, 8),
                 ("pp2dp2", {"pp": 2, "dp": 2}, 2, 4),
                 ("pp2tp2", {"pp": 2, "tp": 2}, 2, 4)],
             2: [("pp2", {"pp": 2}, 2, 8)]}.get(n, [("pp1", {}, 2, 8)])
    if parity and n == 4:
        grids.append(("pp2sp2", {"pp": 2, "sp": 2}, 2, 4))
    return grids


def pp_program(fluid, gpt, cfg, rows, S, stages, micro, lr, seed=11,
               axes=None):
    """GPT pretraining as ``gpt_pretrain`` builds it, its decoder layers
    in a ``layers.Pipeline`` of ``stages`` uniform stages of
    ``num_layers / stages`` layers over ``micro`` microbatches, Adam at
    ``lr`` through ``PipelineOptimizer``: (main, startup, loss). With a
    ``tp`` axis in ``axes`` the word embedding (and so the tied head) is
    annotated ``("tp", None)`` as ``gpt.apply_tp_sharding`` annotates
    it; with an ``sp`` axis the pipeline's input is pinned to ``("dp",
    "sp", None)``."""
    axes = axes or {}
    L = fluid.layers
    init = fluid.initializer
    h = cfg.hidden_size
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed

    def normal(name):
        return fluid.ParamAttr(name=name, initializer=init.Normal(
            0.0, cfg.initializer_range))

    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = L.data("tokens", [rows, S], dtype="int32")
        labels = L.data("labels", [rows, S], dtype="int32")
        loss_mask = L.data("loss_mask", [rows, S], dtype="float32")
        pos_ids = L.data("pos_ids", [rows, S], dtype="int32")
        x = L.elementwise_add(
            L.embedding(tokens, size=[cfg.vocab_size, h],
                        param_attr=normal("word_embedding")),
            L.embedding(pos_ids, size=[cfg.max_position, h],
                        param_attr=normal("pos_embedding")))
        x = L.dropout(x, cfg.dropout,
                      dropout_implementation="upscale_in_train")
        if axes.get("sp", 1) > 1:
            x = L.collective.shard(x, "dp", "sp", None)
        pipe = L.Pipeline(num_stages=stages, num_microbatches=micro)
        with pipe.stage():
            y = pipe.stage_input(x)
            for i in range(cfg.num_layers // stages):
                y = gpt.decoder_layer(cfg, y, i, False)
            pipe.stage_output(y)
        x = L.layer_norm(
            pipe(), begin_norm_axis=2,
            param_attr=fluid.ParamAttr(name="final_ln_scale",
                                       initializer=init.Constant(1.0)),
            bias_attr=fluid.ParamAttr(name="final_ln_bias",
                                      initializer=init.Constant(0.0)))
        word_emb = main.global_block().var("word_embedding")
        logits = L.matmul(L.reshape(x, [-1, h]), word_emb,
                          transpose_y=True)
        ce = L.softmax_with_cross_entropy(logits,
                                          L.reshape(labels, [-1, 1]))
        w = L.reshape(loss_mask, [-1, 1])
        loss = L.elementwise_div(
            L.reduce_sum(L.elementwise_mul(ce, w)),
            L.elementwise_add(L.reduce_sum(w),
                              L.fill_constant([1], "float32", 1e-9)))
        if axes.get("tp", 1) > 1:
            fluid.parallel.mesh.set_param_dist_attr(
                main, "word_embedding", ("tp", None))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.Adam(lr), num_microbatches=micro).minimize(loss)
    return main, startup, loss


def _pp_world(axes):
    from paddle_tpu_torch.parallel import mesh
    return mesh.make_mesh(mesh.MeshConfig(**axes))


def _pp_rows(feed, d, n):
    b = next(iter(feed.values())).shape[0] // n
    return {k: v[d * b:(d + 1) * b] for k, v in feed.items()}


def pp_launches_a_step(layers, micro):
    """K1, K3 and K4 launches a step on a rank that runs ``layers``
    decoder layers (its stage's, or all of them on the sequential path)
    over ``micro`` microbatches: K1 once a layer and microbatch in the
    forward and once more in the grad's recompute of the stage, K3 and
    K4 once each in the grad (causal S 2048 takes K3 + K4)."""
    return {"flash_attention_fwd": 2 * micro * layers,
            "flash_attention_bwd_dq": micro * layers,
            "flash_attention_bwd_dkv": micro * layers,
            "flash_attention_bwd_single": 0, "paged_attention": 0}


def _pp_parity(torch, np, args, rank, n, place):
    """The contract at small width, float32: the narrow GPT with 2
    decoder layers a stage through ``with_data_parallel(mesh=...)`` on
    each grid of :func:`pp_grids`, 3 Adam steps eagerly and by a
    run_steps slab from copies of one startup scope; rank 0 also runs
    the plain program (the sequential path, every row) from that
    startup. Parameters are gathered over pp before the comparison."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import gathered
    p = args["run"]
    B, S = p["B"], p["S"]
    rec = {"cases": []}
    exe = fluid.Executor(place)
    for tag, axes, stages, _ in pp_grids(n, parity=True):
        cfg = gpt.GPTConfig(**p["cfg"],
                            num_layers=stages * p["layers_a_stage"])
        grid = _pp_world(axes)
        d, dp = grid.coords()["dp"], grid.dp
        rows = B // dp
        feeds = [gpt.random_batch(cfg, B, S,
                                  rng=np.random.default_rng(610 + i))
                 for i in range(p["steps"])]
        mine = [_pp_rows(f, d, dp) for f in feeds]
        main, startup, loss = pp_program(fluid, gpt, cfg, rows, S, stages,
                                         rows // p["micro_rows"], p["lr"],
                                         axes=axes)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        s0 = fluid.Scope()
        exe.run(startup, scope=s0)
        sA, sB = (copied_scope(torch, fluid, s0) for _ in range(2))
        eager = [exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
                 for f in mine]
        slab = exe.run_steps(comp, feed=mine, fetch_list=[loss],
                             scope=sB)[0]
        diff = scope_diff(torch, sA, sB)
        params = [q.name for q in main.all_parameters()]
        with gathered(sA):
            whole = {q: sA.find_var(q).detach().clone() for q in params}
        case = {"grid": tag, **grid.coords(), "stages": stages,
                "losses": [float(np.ravel(v)[0]) for v in eager],
                "slab_bitwise": bool(np.array_equal(
                    np.stack(eager).reshape(-1), np.ravel(slab)))
                and not diff, "scope_diff": diff[:4],
                "slices": len(getattr(comp.program, "_pp_layouts", {})),
                "digest": _state_digest(torch, whole.items())}
        if rank == 0:
            pmain, _, ploss = pp_program(fluid, gpt, cfg, B, S, stages,
                                         B // p["micro_rows"], p["lr"])
            sp_ = copied_scope(torch, fluid, s0)
            plain = [exe.run(pmain, feed=f, fetch_list=[ploss],
                             scope=sp_)[0] for f in feeds]
            top = max(float(sp_.find_var(q).abs().max()) for q in params)
            errs = {q: float((whole[q].float() - sp_.find_var(q)
                              .float()).abs().max()) for q in params}
            case.update({
                "plain_losses": [float(np.ravel(v)[0]) for v in plain],
                "max_err_of_model_max": max(errs.values()) / top,
                "worst": max(errs, key=errs.get)})
            del sp_
        rec["cases"].append(case)
        del s0, sA, sB
        _release(torch, exe)
    return rec


def _pp_gpt(torch, np, args, rank, n, place):
    """GPT-base at B8 S2048 with its decoder layers in a
    ``layers.Pipeline`` on each grid of :func:`pp_grids`: 2 eager steps
    and a run_steps slab of 3 (captured, the shifts, broadcasts and the
    dp all-reduce inside) against an all-eager twin from a copy of the
    same start (bitwise), a timed slab, a profiled slab; the gathered
    parameters saved and each rank's stage slices read back from the
    files; the captured step freed before the next grid's. Rank 0 then
    runs each grid's program on its card alone (the sequential path,
    every row) for the same 5 steps from the same startup (2 eager, a
    slab of 3), and a timed slab. The peaks are over the grid's run from
    after its copies of the start were made (``peak_eager_gb``: its
    eager steps only)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import mesh
    run = args["run"]
    B, S, K, E = run["B"], run["S"], run["K"], run["eager"]
    cuda = not args.get("cpu")
    cfg = gpt.GPTConfig(**args["cfg"]) if args.get("cfg") \
        else gpt.GPTConfig.base()
    cfg.dropout = 0.0
    if args.get("layers"):
        cfg.num_layers = args["layers"]
    feeds = [gpt.random_batch(cfg, B, S,
                              rng=np.random.default_rng(run["seed"] + i))
             for i in range(E + K)]
    exe = fluid.Executor(place)
    dev = exe.device
    rec = {"B": B, "S": S, "layers": cfg.num_layers, "runs": {},
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    starts = {}
    for tag, axes, stages, micro in pp_grids(n):
        grid = _pp_world(axes)
        c = grid.coords()
        d, dp = c["dp"], grid.dp
        rows = B // dp
        pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in _pp_rows(f, d, dp).items()} for f in feeds]
        slab = {k: torch.stack([f[k] for f in pool[E:]]) for k in pool[0]}
        main, startup, loss = pp_program(fluid, gpt, cfg, rows, S, stages,
                                         micro, run["lr"], axes=axes)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if rank == 0 and stages not in starts:
            # one plain run a stage count: the same program and start
            starts[stages] = {k: v.cpu() for k, v in scope.items()
                              if isinstance(v, torch.Tensor)}
        twin = copied_scope(torch, fluid, scope)
        # the peaks leave out the copies: the twin and rank 0's start
        base = _peak_base(torch, cuda)
        eager, wall = [], []
        for f in pool[:E]:
            lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                comp, feed=f, fetch_list=[loss], scope=scope)[0])
            eager.append(float(np.ravel(lv)[0]))
            wall.append(ms)
        peak_eager = _peak_from(torch, cuda, base)
        (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        twin_losses, twin_ms = [], []
        for f in pool:
            lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                comp, feed=f, fetch_list=[loss], scope=twin)[0])
            twin_losses.append(float(np.ravel(lv)[0]))
            twin_ms.append(ms)
        losses = eager + [float(v) for v in np.ravel(got)]
        diff = scope_diff(torch, scope, twin)
        bitwise = losses == twin_losses and not diff
        del twin
        before = {w.__name__: w.launches for w in kernels.COUNTED}
        _, slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        per_step = {w.__name__: (w.launches - before[w.__name__]) / K
                    for w in kernels.COUNTED}
        pipelined = bool(getattr(comp.program, "_pp_layouts", {}))
        here = cfg.num_layers // stages if pipelined else cfg.num_layers
        r = {"grid": tag, "coords": c, "stages": stages, "micro": micro,
             "rows": rows, "pipelined": pipelined, "losses": losses,
             "slab_bitwise": bitwise, "scope_diff": diff[:4],
             "eager_ms": wall, "eager_ms_twin": twin_ms,
             "first_slab_ms_with_capture": cap_ms,
             "ms_per_step": slab_ms / K,
             "tokens_per_s_rank_rows": rows * S / (slab_ms / K) * 1e3,
             "launches_per_step_run_steps": per_step,
             "launches_per_step_want": pp_launches_a_step(here, micro),
             "peak_eager_gb": peak_eager}
        if cuda:
            prof = kernel_profile(torch, lambda: exe.run_steps(
                comp, feed=slab, fetch_list=[loss], scope=scope))
            r.update({"nccl_kernels_per_step": len(prof["nccl_us"]) / K,
                      "nccl_ms_per_step": prof["nccl_busy_ms"] / K,
                      "compute_ms_per_step": prof["compute_busy_ms"] / K,
                      "busy_ms_per_step": prof["busy_ms"] / K,
                      "wall_ms_profiled_per_step": prof["wall_ms"] / K,
                      "idle_share_replay":
                          1 - prof["busy_ms"] / prof["wall_ms"],
                      "peak_mem_gb": _peak_from(torch, cuda, base)})
        params = [q.name for q in main.all_parameters()]
        stacked = set(getattr(comp.program, "_pp_layouts", {}))
        # tp shards and stage slices differ by rank; stage slices are
        # equal across the tp ranks of a stage
        r["digest_replicated"] = _state_digest(torch, [
            (q, scope.find_var(q)) for q in params
            if q not in comp._tp_layouts])
        r["digest_stage"] = _state_digest(torch, [
            (q, scope.find_var(q)) for q in params if q in stacked])
        # the gathered save, each rank's stage slices read back from it
        out_dir = os.path.join(PP_DIR, f"save_{tag}")
        if stacked:
            fluid.io.save_params(exe, out_dir, main_program=main,
                                 scope=scope)
        match = True
        for q in sorted(stacked & set(params)):
            saved = np.load(os.path.join(out_dir,
                                         fluid.io._escape(q) + ".npy"))
            mine = scope.find_var(q).cpu().numpy()
            match = match and mine.shape == (1,) + saved.shape[1:] and \
                np.array_equal(saved[c["pp"]:c["pp"] + 1], mine)
        r["slices_match_save"] = match
        r["stage_slices"] = len(stacked)
        rec["runs"][tag] = r
        mesh.barrier()
        if rank == 0:
            import shutil
            shutil.rmtree(out_dir, ignore_errors=True)
        del scope
        _release(torch, exe)
    if rank == 0 and n > 1:
        rec["plain"] = {}
        pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in f.items()} for f in feeds]
        slab = {k: torch.stack([f[k] for f in pool[E:]]) for k in pool[0]}
        for stages, start in starts.items():
            tag = f"stages{stages}"
            main, _, loss = pp_program(fluid, gpt, cfg, B, S, stages,
                                       8, run["lr"])
            scope = fluid.Scope()
            for k, v in start.items():
                scope.set(k, v.to(dev))
            base = _peak_base(torch, cuda)
            plain, wall = [], []
            for f in pool[:E]:
                lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                    main, feed=f, fetch_list=[loss], scope=scope)[0])
                plain.append(float(np.ravel(lv)[0]))
                wall.append(ms)
            peak_eager = _peak_from(torch, cuda, base)
            (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
                main, feed=slab, fetch_list=[loss], scope=scope))
            _, slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
                main, feed=slab, fetch_list=[loss], scope=scope))
            rec["plain"][tag] = {
                "losses": plain + [float(v) for v in np.ravel(got)],
                "eager_ms": wall, "first_slab_ms_with_capture": cap_ms,
                "ms_per_step": slab_ms / K,
                "tokens_per_s": B * S / (slab_ms / K) * 1e3,
                "stages": stages, "micro": 8, "peak_eager_gb": peak_eager,
                "peak_mem_gb": _peak_from(torch, cuda, base)}
            del scope
            _release(torch, exe)
        starts.clear()
    return rec


def _pp_failures(name, ranks, args):
    bad = []
    if name == "pp_parity":
        for i, case in enumerate(ranks[0]["cases"]):
            tag = case["grid"]
            for r in ranks:
                if not r["cases"][i]["slab_bitwise"]:
                    bad.append(f"pp_parity {tag}: rank {r['rank']}'s "
                               f"run_steps is not its eager steps")
                if r["cases"][i]["digest"] != case["digest"]:
                    bad.append(f"pp_parity {tag}: rank {r['rank']}'s "
                               f"gathered parameters differ from rank 0's")
            if case["max_err_of_model_max"] > 1e-4:
                bad.append(f"pp_parity {tag}: parameters off the plain run "
                           f"by {case['max_err_of_model_max']:.3g} of max "
                           f"|ref| ({case['worst']})")
        return bad
    r0 = ranks[0]
    for tag in r0["runs"]:
        per_dp = {}
        for r in ranks:
            run = r["runs"][tag]
            per_dp.setdefault(run["coords"]["dp"], run["losses"])
            if run["losses"] != per_dp[run["coords"]["dp"]]:
                bad.append(f"pp_gpt {tag}: rank {r['rank']}'s losses differ "
                           f"from its dp coordinate's other ranks'")
            if not run["slab_bitwise"]:
                bad.append(f"pp_gpt {tag}: rank {r['rank']}'s run_steps is "
                           f"not its eager twin's steps {run['scope_diff']}")
            if not run["slices_match_save"]:
                bad.append(f"pp_gpt {tag}: rank {r['rank']}'s stage slices "
                           f"differ from the gathered save")
            if run["digest_replicated"] != \
                    r0["runs"][tag]["digest_replicated"]:
                bad.append(f"pp_gpt {tag}: rank {r['rank']}'s replicated "
                           f"parameters differ from rank 0's")
            same = [q["runs"][tag]["digest_stage"] for q in ranks
                    if q["runs"][tag]["coords"]["pp"] == run["coords"]["pp"]]
            if any(dg != run["digest_stage"] for dg in same):
                bad.append(f"pp_gpt {tag}: the ranks of stage "
                           f"{run['coords']['pp']} hold different slices")
            if not args.get("cpu"):
                per = run["launches_per_step_run_steps"]
                want = run["launches_per_step_want"]
                if {k: per.get(k, 0) for k in want} != want:
                    bad.append(f"pp_gpt {tag}: rank {r['rank']} launched "
                               f"{per} a step, not {want}")
        mean = [sum(col) / len(col) for col in zip(*per_dp.values())]
        plain = (r0.get("plain") or {}).get(
            f"stages{r0['runs'][tag]['stages']}")
        if plain is not None:
            for i, (a, b) in enumerate(zip(mean, plain["losses"])):
                if not math.isfinite(a) or abs(a - b) > PP_LOSS_RTOL * abs(b):
                    bad.append(f"pp_gpt {tag}: step {i}'s loss {a} is off "
                               f"the one-card run's {b} (rtol "
                               f"{PP_LOSS_RTOL})")
        elif not all(math.isfinite(a) for a in mean):
            bad.append(f"pp_gpt {tag}: a loss is not finite: {mean}")
    return bad


def pp_phase(torch, np, name, nproc, args=None, timeout=900):
    """One pipeline-parallel phase at ``nproc`` ranks (one a card),
    checked and printed with the card, its power limit and N. Returns
    the record."""
    args = dict(args or {})
    if nproc == 1 and name == "pp_gpt" and not args.get("cpu"):
        # one card pipelines nothing: 2 layers through the same code
        args.setdefault("layers", 2)
    args.setdefault("run", {"pp_parity": PP_PARITY,
                            "pp_gpt": PP_GPT}[name])
    ranks, launch = dp_launch(torch, name, nproc, args, timeout)
    rec = {"phase": name, **CARD, "N": nproc, "launch": launch}
    bad = _pp_failures(name, ranks, args)
    r0 = ranks[0]
    if name == "pp_parity":
        rec["cases"] = [{k: c.get(k) for k in (
            "grid", "stages", "losses", "plain_losses", "slices",
            "max_err_of_model_max", "worst")} for c in r0["cases"]]
        rec["slab_bitwise"] = all(c["slab_bitwise"] for r in ranks
                                  for c in r["cases"])
    else:
        rec.update({k: r0[k] for k in ("B", "S", "layers", "tf32")})
        rec["plain"] = r0.get("plain")
        rec["runs"] = {}
        for tag, run in r0["runs"].items():
            slow = max(ranks, key=lambda r: r["runs"][tag]["ms_per_step"])
            row = {k: v for k, v in run.items()
                   if k not in ("digest_replicated", "digest_stage",
                                "coords")}
            row["ms_per_step_slowest"] = slow["runs"][tag]["ms_per_step"]
            row["tokens_per_s_total"] = r0["B"] * r0["S"] / \
                row["ms_per_step_slowest"] * 1e3
            for k in ("peak_mem_gb", "peak_eager_gb"):
                row[f"{k}_a_card"] = max(r["runs"][tag].get(k) or 0.0
                                         for r in ranks)
            for k in ("busy_ms_per_step", "nccl_ms_per_step",
                      "nccl_kernels_per_step", "idle_share_replay",
                      "ms_per_step", "launches_per_step_run_steps"):
                row[f"{k}_by_rank"] = [r["runs"][tag].get(k)
                                       for r in ranks]
            rec["runs"][tag] = row
    if nproc == 1:
        rec["note"] = ("one card: the sequential path through the same "
                       "code; no pipelining was measured")
        print(f"{name}: {rec['note']}", flush=True)
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def pp_phases(torch, np, counters, name, n=None, args=None):
    """Pipeline-parallel phase ``name`` at N = n (default: every card);
    adds the ranks' kernel launches to ``counters``."""
    n = n or torch.cuda.device_count()
    rec = pp_phase(torch, np, name, n, args)
    for r in rec["ranks"]:
        for w, c in r["launches"].items():
            cw = counters.get(w)
            if cw is not None:
                cw.launches += c
                if hasattr(cw, "bf16_launches"):
                    cw.bf16_launches += r["bf16_launches"].get(w, 0)
    return rec


def pp_kernel_shapes(torch, fa):
    """K1, K3 and K4 against their plain versions at pp_gpt's stage
    shape (one microbatch: B1 H12 S2048 D64, float32, causal, the packed
    qkv views), each timed beside SDPA's forward or backward with the
    same causal mask; not counted."""
    recs = []
    # B1: pp 4 and pp 2 x dp 2's microbatch; B2: pp 2 x tp 2's
    for B in (1, 2):
        recs.append(flash_phase(torch, fa, B, 12, 2048, 64, "float32",
                                True, False, seed=2301 + B, packed=True))
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            recs.append(bwd_phase(torch, fa, name, B, 12, 2048, 64,
                                  "float32", True, False, seed=2303 + B,
                                  packed=True))
    emit({"phase": "pp_kernel_shapes", **CARD, "rows": [
        {k: r[k] for k in ("phase", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by", "max_abs_err", "ok")}
        for r in recs]})
    return recs


# ------------------------------------------------ expert parallelism

MOE_DIR = os.path.join(ROOT, "build", "chip_smoke_moe")
# moe_gpt: a Switch GPT-base at bench_gpt_long's shape (B8 S2048),
# dropout 0, float32 (matmuls without TF32), Adam at a constant 1e-4:
# decoder layers 1, 3, ..., 11 with their FFN a switch_moe of 8 experts
# of width 3072 at capacity factor 1.25 over the [B*S, 768] hidden
# states (N 16384, C 2560; Switch Transformers' placement), the loss the
# LM loss + 0.01 x the mean of the aux losses; 2 eager steps, then a
# run_steps slab of 3
MOE_GPT = {"B": 8, "S": 2048, "eager": 2, "K": 3, "lr": 1e-4, "seed": 700,
           "experts": 8, "d_hidden": 3072, "capacity_factor": 1.25,
           "aux_w": 0.01}
# the losses against rank 0's one-card run of the same program and
# batches: routing is discontinuous, so a gate within rounding of a tie
# (the chunked gate matmuls, the dp all-reduce's order) may send a token
# to another expert or past the capacity
MOE_LOSS_RTOL = 1e-3
# moe_parity: a narrow Switch GPT (2 layers, the second a switch_moe of
# 4 experts), float32, 3 Adam steps
MOE_PARITY = {"cfg": {"vocab_size": 1024, "hidden_size": 256,
                      "num_heads": 4, "ffn_size": 1024, "max_position": 128,
                      "dropout": 0.0, "num_layers": 2},
              "B": 8, "S": 128, "experts": 4, "d_hidden": 1024,
              "capacity_factor": 1.25, "aux_w": 0.01, "steps": 3,
              "lr": 1e-3}


def moe_grids(n, name="moe_gpt"):
    """The grids of the moe phases on ``n`` cards: (tag, mesh axes, what
    the grid changes of the phase's run dict). Four cards: ep 4 (2
    experts a card), ep 2 x dp 2 (4 experts a card, 4 rows a dp rank)
    and ep 2 x tp 2 (``gpt.apply_tp_sharding``: the attention and the
    dense FFNs split, the experts whole on the tp ranks); ``moe_parity``
    also ep 2 x sp 2 (every layer a MoE layer, non-causal: the kernels
    take no query offset under the sequence split) and pp 2 x ep
    2 (the dense layers in a 2-stage pipeline of 2 microbatches, one MoE
    layer after it); two: ep 2; one: ep 1 through the same code."""
    grids = {4: [("ep4", {"ep": 4}, {}), ("ep2dp2", {"ep": 2, "dp": 2}, {}),
                 ("ep2tp2", {"ep": 2, "tp": 2}, {})],
             2: [("ep2", {"ep": 2}, {})]}.get(n, [("ep1", {}, {})])
    if n == 4 and name == "moe_parity":
        grids += [("ep2sp2", {"ep": 2, "sp": 2},
                   {"moe_every": 1, "causal": False}),
                  ("pp2ep2", {"pp": 2, "ep": 2},
                   {"pipe_stages": 2, "micro": 2})]
    return grids


def moe_program(fluid, gpt, cfg, rows, S, run, seed=13, axes=None):
    """A Switch GPT: ``gpt_pretrain``'s body with the FFN of every other
    decoder layer (1, 3, ...; every layer at ``run["moe_every"]`` 1) a
    ``switch_moe`` over the ``[rows * S, hidden]`` states (the rest of
    ``gpt.decoder_layer``'s body as is; its attention non-causal at
    ``run["causal"]`` False), the loss the LM loss + ``aux_w`` x the
    mean of the aux losses, Adam at ``run["lr"]``. ``run["pipe_stages"]``:
    the dense layers in a ``layers.Pipeline`` of that many stages over
    ``run["micro"]`` microbatches (``PipelineOptimizer``), then one MoE
    layer. ``axes``: a ``tp`` axis annotates the split as
    ``gpt.apply_tp_sharding``, an ``sp`` one pins the embeddings' output
    to ``("dp", "sp", None)``. Takes either package's ``fluid`` and
    ``gpt``: (main, startup, loss, the MoE layers' inputs)."""
    axes = axes or {}
    every = run.get("moe_every", 2)
    causal = run.get("causal", True)
    stages = run.get("pipe_stages")
    L = fluid.layers
    init = fluid.initializer
    h, nh = cfg.hidden_size, cfg.num_heads
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed

    def normal(name):
        return fluid.ParamAttr(name=name, initializer=init.Normal(
            0.0, cfg.initializer_range))

    def ln(x, name):
        return L.layer_norm(
            x, begin_norm_axis=2,
            param_attr=fluid.ParamAttr(name=f"{name}_scale",
                                       initializer=init.Constant(1.0)),
            bias_attr=fluid.ParamAttr(name=f"{name}_bias",
                                      initializer=init.Constant(0.0)))

    def fc(x, size, name, act=None):
        return L.fc(x, size, num_flatten_dims=2, act=act,
                    param_attr=normal(f"{name}.w_0"),
                    bias_attr=fluid.ParamAttr(
                        name=f"{name}.b_0", initializer=init.Constant(0.0)))

    def moe_layer(x, i):
        pre = f"decoder_layer_{i}"
        a = ln(x, f"{pre}_pre_att_ln")
        qkv = fc(a, 3 * h, f"{pre}_qkv")
        heads = []
        for j in range(3):
            t = L.slice(qkv, axes=[2], starts=[j * h], ends=[(j + 1) * h])
            heads.append(L.transpose(L.reshape(t, [0, 0, nh, h // nh]),
                                     [0, 2, 1, 3]))
        ctx = L.flash_attention(*heads, causal=causal)
        ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
        attn = L.dropout(fc(ctx, h, f"{pre}_att_out"), cfg.dropout,
                         dropout_implementation="upscale_in_train")
        x = L.elementwise_add(x, attn)
        f = L.reshape(ln(x, f"{pre}_pre_ffn_ln"), [-1, h])
        out, aux = L.switch_moe(f, num_experts=run["experts"],
                                d_hidden=run["d_hidden"],
                                capacity_factor=run["capacity_factor"])
        ffn = L.dropout(L.reshape(out, [rows, S, h]), cfg.dropout,
                        dropout_implementation="upscale_in_train")
        return L.elementwise_add(x, ffn), aux, f

    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = L.data("tokens", [rows, S], dtype="int32")
        labels = L.data("labels", [rows, S], dtype="int32")
        loss_mask = L.data("loss_mask", [rows, S], dtype="float32")
        pos_ids = L.data("pos_ids", [rows, S], dtype="int32")
        x = L.elementwise_add(
            L.embedding(tokens, size=[cfg.vocab_size, h],
                        param_attr=normal("word_embedding")),
            L.embedding(pos_ids, size=[cfg.max_position, h],
                        param_attr=normal("pos_embedding")))
        x = L.dropout(x, cfg.dropout,
                      dropout_implementation="upscale_in_train")
        if axes.get("sp", 1) > 1:
            x = L.collective.shard(x, "dp", "sp", None)
        auxes, moe_in = [], []
        if stages:
            pipe = L.Pipeline(num_stages=stages,
                              num_microbatches=run["micro"])
            with pipe.stage():
                y = pipe.stage_input(x)
                for i in range(cfg.num_layers // stages):
                    y = gpt.decoder_layer(cfg, y, i, False)
                pipe.stage_output(y)
            x, aux, f = moe_layer(pipe(), cfg.num_layers)
            auxes.append(aux)
            moe_in.append(f)
        for i in range(0 if stages else cfg.num_layers):
            if i % every == every - 1:
                x, aux, f = moe_layer(x, i)
                auxes.append(aux)
                moe_in.append(f)
            else:
                x = gpt.decoder_layer(cfg, x, i, False)
        x = ln(x, "final_ln")
        word_emb = main.global_block().var("word_embedding")
        logits = L.matmul(L.reshape(x, [-1, h]), word_emb,
                          transpose_y=True)
        ce = L.softmax_with_cross_entropy(logits,
                                          L.reshape(labels, [-1, 1]))
        w = L.reshape(loss_mask, [-1, 1])
        loss = L.elementwise_div(
            L.reduce_sum(L.elementwise_mul(ce, w)),
            L.elementwise_add(L.reduce_sum(w),
                              L.fill_constant([1], "float32", 1e-9)))
        if auxes:
            loss = L.elementwise_add(loss, L.scale(
                L.sums(auxes), run["aux_w"] / len(auxes)))
        if axes.get("tp", 1) > 1:
            gpt.apply_tp_sharding(main, cfg)
        opt = fluid.optimizer.Adam(run["lr"])
        if stages:
            opt = fluid.optimizer.PipelineOptimizer(
                opt, num_microbatches=run["micro"])
        opt.minimize(loss)
    return main, startup, loss, moe_in


def moe_launches_a_step(layers):
    """K1, K3 and K4 launches a step of a Switch GPT of ``layers``
    decoder layers at S 2048 (causal S 2048 takes K3 + K4): one each a
    layer, MoE layers included (their attention is the dense layers')."""
    return {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "flash_attention_bwd_single": 0, "paged_attention": 0}


def moe_dropped(torch, gates_in, gate_ws, run, N):
    """The share of tokens each MoE layer dropped, from its input rows
    (the whole batch, in row order) and its gate weight at that step:
    the top-1 expert's count over the capacity, over all N tokens."""
    E = run["experts"]
    C = max(int(run["capacity_factor"] * N / E), 1)
    out = []
    for x, gw in zip(gates_in, gate_ws):
        x = torch.as_tensor(x, device=gw.device)
        expert = torch.argmax(torch.softmax(x @ gw, dim=-1), dim=-1)
        counts = torch.bincount(expert, minlength=E)
        out.append(float((counts - C).clamp_min(0).sum()) / N)
    return out


def _moe_parity(torch, np, args, rank, n, place):
    """The contract at small width, float32: the narrow Switch GPT
    through ``with_data_parallel(mesh=...)`` on each grid of
    :func:`moe_grids`, 3 Adam steps eagerly and by a run_steps slab from
    copies of one startup scope; rank 0 also runs the plain program on
    every row from that startup. Parameters are gathered over ep before
    the comparison."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import gathered
    p = args["run"]
    B, S = p["B"], p["S"]
    cfg = gpt.GPTConfig(**p["cfg"])
    rec = {"cases": []}
    exe = fluid.Executor(place)
    feeds = [gpt.random_batch(cfg, B, S, rng=np.random.default_rng(710 + i))
             for i in range(p["steps"])]
    for tag, axes, over in moe_grids(n, "moe_parity"):
        grid = _pp_world(axes)
        d, dp = grid.coords()["dp"], grid.dp
        mine = [_pp_rows(f, d, dp) for f in feeds]
        q = dict(p, **over)
        main, startup, loss, _ = moe_program(fluid, gpt, cfg, B // dp, S, q,
                                             axes=axes)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        s0 = fluid.Scope()
        exe.run(startup, scope=s0)
        sA, sB = (copied_scope(torch, fluid, s0) for _ in range(2))
        eager = [exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
                 for f in mine]
        slab = exe.run_steps(comp, feed=mine, fetch_list=[loss],
                             scope=sB)[0]
        diff = scope_diff(torch, sA, sB)
        params = [q.name for q in main.all_parameters()]
        with gathered(sA):
            whole = {q: sA.find_var(q).detach().clone() for q in params}
        case = {"grid": tag, **grid.coords(),
                "losses": [float(np.ravel(v)[0]) for v in eager],
                "slab_bitwise": bool(np.array_equal(
                    np.stack(eager).reshape(-1), np.ravel(slab)))
                and not diff, "scope_diff": diff[:4],
                "slices": len(getattr(comp.program, "_ep_layouts", {})),
                "digest": _state_digest(torch, whole.items())}
        if rank == 0:
            pmain, _, ploss, _ = moe_program(fluid, gpt, cfg, B, S, q)
            sp_ = copied_scope(torch, fluid, s0)
            plain = [exe.run(pmain, feed=f, fetch_list=[ploss],
                             scope=sp_)[0] for f in feeds]
            top = max(float(sp_.find_var(q).abs().max()) for q in params)
            errs = {q: float((whole[q].float() - sp_.find_var(q)
                              .float()).abs().max()) for q in params}
            case.update({
                "plain_losses": [float(np.ravel(v)[0]) for v in plain],
                "max_err_of_model_max": max(errs.values()) / top,
                "worst": max(errs, key=errs.get)})
            del sp_
        rec["cases"].append(case)
        del s0, sA, sB
        _release(torch, exe)
    return rec


def _moe_gpt(torch, np, args, rank, n, place):
    """The Switch GPT-base (``MOE_GPT``) on each grid of
    :func:`moe_grids`: 2 eager steps and a run_steps slab of 3
    (captured, the all-to-alls, the count all-gathers and the dp
    all-reduce inside) against an all-eager twin from a copy of the same
    start (bitwise), a timed slab, a profiled slab; the gathered
    parameters saved and each rank's expert slices read back from the
    files; the captured step freed before the next grid's. Rank 0 then
    runs the program on its card alone (every row) for the same 5 steps
    from the same startup and a timed slab, and reads each MoE layer's
    dropped share at step 0 from its gate inputs (at N = 1 in the grid's
    own run)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import mesh
    run = args["run"]
    B, S, K, E = run["B"], run["S"], run["K"], run["eager"]
    cuda = not args.get("cpu")
    cfg = gpt.GPTConfig(**args["cfg"]) if args.get("cfg") \
        else gpt.GPTConfig.base()
    cfg.dropout = 0.0
    if args.get("layers"):
        cfg.num_layers = args["layers"]
    feeds = [gpt.random_batch(cfg, B, S,
                              rng=np.random.default_rng(run["seed"] + i))
             for i in range(E + K)]
    exe = fluid.Executor(place)
    dev = exe.device
    rec = {"B": B, "S": S, "layers": cfg.num_layers, "runs": {},
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    start = None

    def dropped(main, moe_in, scope, feed, loss, program):
        """Step 0 eagerly with the MoE inputs fetched: (loss, shares)."""
        gws = [scope.find_var(op.input("GateW")[0]).detach().clone()
               for op in main.global_block().ops if op.type == "switch_moe"]
        got = exe.run(program, feed=feed, fetch_list=[loss] + moe_in,
                      scope=scope)
        return got[0], moe_dropped(torch, got[1:], gws, run, B * S)

    for tag, axes, _ in moe_grids(n):
        grid = _pp_world(axes)
        c = grid.coords()
        d, dp = c["dp"], grid.dp
        rows = B // dp
        pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in _pp_rows(f, d, dp).items()} for f in feeds]
        slab = {k: torch.stack([f[k] for f in pool[E:]]) for k in pool[0]}
        main, startup, loss, moe_in = moe_program(fluid, gpt, cfg, rows, S,
                                                  run, axes=axes)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if rank == 0 and start is None:
            start = {k: v.cpu() for k, v in scope.items()
                     if isinstance(v, torch.Tensor)}
        twin = copied_scope(torch, fluid, scope)
        base = _peak_base(torch, cuda)
        eager, wall, shares = [], [], None
        for i, f in enumerate(pool[:E]):
            if i == 0 and n == 1:
                (lv, shares), ms = _timed_wall(torch, cuda, lambda f=f: (
                    dropped(main, moe_in, scope, f, loss, comp)))
            else:
                lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                    comp, feed=f, fetch_list=[loss], scope=scope)[0])
            eager.append(float(np.ravel(lv)[0]))
            wall.append(ms)
        peak_eager = _peak_from(torch, cuda, base)
        (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        twin_losses, twin_ms = [], []
        for f in pool:
            lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                comp, feed=f, fetch_list=[loss], scope=twin)[0])
            twin_losses.append(float(np.ravel(lv)[0]))
            twin_ms.append(ms)
        losses = eager + [float(v) for v in np.ravel(got)]
        diff = scope_diff(torch, scope, twin)
        bitwise = losses == twin_losses and not diff
        del twin
        before = {w.__name__: w.launches for w in kernels.COUNTED}
        _, slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            comp, feed=slab, fetch_list=[loss], scope=scope))
        per_step = {w.__name__: (w.launches - before[w.__name__]) / K
                    for w in kernels.COUNTED}
        r = {"grid": tag, "coords": c, "rows": rows, "losses": losses,
             "slab_bitwise": bitwise, "scope_diff": diff[:4],
             "eager_ms": wall, "eager_ms_twin": twin_ms,
             "first_slab_ms_with_capture": cap_ms,
             "ms_per_step": slab_ms / K,
             "launches_per_step_run_steps": per_step,
             "launches_per_step_want": moe_launches_a_step(cfg.num_layers),
             "peak_eager_gb": peak_eager, "dropped_share_step0": shares}
        if cuda:
            prof = kernel_profile(torch, lambda: exe.run_steps(
                comp, feed=slab, fetch_list=[loss], scope=scope))
            r.update({"nccl_kernels_per_step": len(prof["nccl_us"]) / K,
                      "nccl_ms_per_step": prof["nccl_busy_ms"] / K,
                      "nccl_by_kind_per_step": {
                          k: [v[0] / K, v[1] / K]
                          for k, v in prof["nccl_by_kind"].items()},
                      "compute_ms_per_step": prof["compute_busy_ms"] / K,
                      "busy_ms_per_step": prof["busy_ms"] / K,
                      "wall_ms_profiled_per_step": prof["wall_ms"] / K,
                      "idle_share_replay":
                          1 - prof["busy_ms"] / prof["wall_ms"],
                      "peak_mem_gb": _peak_from(torch, cuda, base)})
        params = [q.name for q in main.all_parameters()]
        experts = set(getattr(comp.program, "_ep_layouts", {}))
        # the state no axis splits: equal on every rank, tp ranks too
        shards = set(getattr(comp.program, "_tp_layouts", {}))
        r["digest_replicated"] = _state_digest(torch, [
            (q, scope.find_var(q)) for q in params
            if q not in experts and q not in shards])
        r["tp_shards"] = len(shards & set(params))
        # the gathered save, each rank's expert slices read back from it
        out_dir = os.path.join(MOE_DIR, f"save_{tag}")
        if experts:
            fluid.io.save_params(exe, out_dir, main_program=main,
                                 scope=scope)
        match = True
        for q in sorted(experts & set(params)):
            saved = np.load(os.path.join(out_dir,
                                         fluid.io._escape(q) + ".npy"))
            mine = scope.find_var(q).cpu().numpy()
            k = mine.shape[0]
            match = match and mine.shape[1:] == saved.shape[1:] and \
                np.array_equal(saved[c["ep"] * k:(c["ep"] + 1) * k], mine)
        r["slices_match_save"] = match
        r["expert_slices"] = len(experts & set(params))
        rec["runs"][tag] = r
        mesh.barrier()
        if rank == 0:
            import shutil
            shutil.rmtree(out_dir, ignore_errors=True)
        del scope
        _release(torch, exe)
    if rank == 0 and n > 1:
        pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in f.items()} for f in feeds]
        slab = {k: torch.stack([f[k] for f in pool[E:]]) for k in pool[0]}
        main, _, loss, moe_in = moe_program(fluid, gpt, cfg, B, S, run)
        scope = fluid.Scope()
        for k, v in start.items():
            scope.set(k, v.to(dev))
        base = _peak_base(torch, cuda)
        plain, wall = [], []
        for i, f in enumerate(pool[:E]):
            if i == 0:
                (lv, shares), ms = _timed_wall(torch, cuda, lambda f=f: (
                    dropped(main, moe_in, scope, f, loss, main)))
            else:
                lv, ms = _timed_wall(torch, cuda, lambda f=f: exe.run(
                    main, feed=f, fetch_list=[loss], scope=scope)[0])
            plain.append(float(np.ravel(lv)[0]))
            wall.append(ms)
        peak_eager = _peak_from(torch, cuda, base)
        (got,), cap_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=scope))
        _, slab_ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=scope))
        rec["plain"] = {
            "losses": plain + [float(v) for v in np.ravel(got)],
            "eager_ms": wall, "first_slab_ms_with_capture": cap_ms,
            "ms_per_step": slab_ms / K,
            "tokens_per_s": B * S / (slab_ms / K) * 1e3,
            "peak_eager_gb": peak_eager,
            "peak_mem_gb": _peak_from(torch, cuda, base),
            "dropped_share_step0": shares}
        del scope
        _release(torch, exe)
    return rec


def _moe_failures(name, ranks, args):
    bad = []
    if name == "moe_parity":
        for i, case in enumerate(ranks[0]["cases"]):
            tag = case["grid"]
            for r in ranks:
                if not r["cases"][i]["slab_bitwise"]:
                    bad.append(f"moe_parity {tag}: rank {r['rank']}'s "
                               f"run_steps is not its eager steps")
                if r["cases"][i]["digest"] != case["digest"]:
                    bad.append(f"moe_parity {tag}: rank {r['rank']}'s "
                               f"gathered parameters differ from rank 0's")
            if case["max_err_of_model_max"] > 1e-4:
                bad.append(f"moe_parity {tag}: parameters off the plain "
                           f"run by {case['max_err_of_model_max']:.3g} of "
                           f"max |ref| ({case['worst']})")
        return bad
    r0 = ranks[0]
    for tag in r0["runs"]:
        per_dp = {}
        for r in ranks:
            run = r["runs"][tag]
            per_dp.setdefault(run["coords"]["dp"], run["losses"])
            if run["losses"] != per_dp[run["coords"]["dp"]]:
                bad.append(f"moe_gpt {tag}: rank {r['rank']}'s losses "
                           f"differ from its dp coordinate's other ranks'")
            if not run["slab_bitwise"]:
                bad.append(f"moe_gpt {tag}: rank {r['rank']}'s run_steps "
                           f"is not its eager twin's steps "
                           f"{run['scope_diff']}")
            if not run["slices_match_save"]:
                bad.append(f"moe_gpt {tag}: rank {r['rank']}'s expert "
                           f"slices differ from the gathered save")
            if run["digest_replicated"] != \
                    r0["runs"][tag]["digest_replicated"]:
                bad.append(f"moe_gpt {tag}: rank {r['rank']}'s replicated "
                           f"parameters differ from rank 0's")
            if not args.get("cpu"):
                per = run["launches_per_step_run_steps"]
                want = run["launches_per_step_want"]
                if {k: per.get(k, 0) for k in want} != want:
                    bad.append(f"moe_gpt {tag}: rank {r['rank']} launched "
                               f"{per} a step, not {want}")
        mean = [sum(col) / len(col) for col in zip(*per_dp.values())]
        plain = r0.get("plain")
        if plain is not None:
            for i, (a, b) in enumerate(zip(mean, plain["losses"])):
                if not math.isfinite(a) or \
                        abs(a - b) > MOE_LOSS_RTOL * abs(b):
                    bad.append(f"moe_gpt {tag}: step {i}'s loss {a} is off "
                               f"the one-card run's {b} (rtol "
                               f"{MOE_LOSS_RTOL})")
        elif not all(math.isfinite(a) for a in mean):
            bad.append(f"moe_gpt {tag}: a loss is not finite: {mean}")
    return bad


def moe_phase(torch, np, name, nproc, args=None, timeout=900):
    """One expert-parallel phase at ``nproc`` ranks (one a card), checked
    and printed with the card, its power limit and N. Returns the
    record."""
    args = dict(args or {})
    if nproc == 1 and name == "moe_gpt" and not args.get("cpu"):
        # one card splits no experts: 2 layers (one dense, one MoE)
        args.setdefault("layers", 2)
    args.setdefault("run", {"moe_parity": MOE_PARITY,
                            "moe_gpt": MOE_GPT}[name])
    ranks, launch = dp_launch(torch, name, nproc, args, timeout)
    rec = {"phase": name, **CARD, "N": nproc, "launch": launch}
    bad = _moe_failures(name, ranks, args)
    r0 = ranks[0]
    if name == "moe_parity":
        rec["cases"] = [{k: c.get(k) for k in (
            "grid", "losses", "plain_losses", "slices",
            "max_err_of_model_max", "worst")} for c in r0["cases"]]
        rec["rank_losses"] = {c["grid"]: [r["cases"][i]["losses"]
                                          for r in ranks]
                              for i, c in enumerate(r0["cases"])}
        rec["slab_bitwise"] = all(c["slab_bitwise"] for r in ranks
                                  for c in r["cases"])
    else:
        rec.update({k: r0[k] for k in ("B", "S", "layers", "tf32")})
        rec["plain"] = r0.get("plain")
        rec["runs"] = {}
        for tag, run in r0["runs"].items():
            slow = max(ranks, key=lambda r: r["runs"][tag]["ms_per_step"])
            row = {k: v for k, v in run.items()
                   if k not in ("digest_replicated", "coords")}
            row["ms_per_step_slowest"] = slow["runs"][tag]["ms_per_step"]
            row["tokens_per_s_total"] = r0["B"] * r0["S"] / \
                row["ms_per_step_slowest"] * 1e3
            for k in ("peak_mem_gb", "peak_eager_gb"):
                row[f"{k}_a_card"] = max(r["runs"][tag].get(k) or 0.0
                                         for r in ranks)
            for k in ("busy_ms_per_step", "nccl_ms_per_step",
                      "nccl_kernels_per_step", "idle_share_replay",
                      "ms_per_step", "launches_per_step_run_steps"):
                row[f"{k}_by_rank"] = [r["runs"][tag].get(k)
                                       for r in ranks]
            rec["runs"][tag] = row
    if nproc == 1:
        rec["note"] = ("one card: ep = 1 through the same code; no expert "
                       "parallelism was measured")
        print(f"{name}: {rec['note']}", flush=True)
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def moe_phases(torch, np, counters, name, n=None, args=None):
    """Expert-parallel phase ``name`` at N = n (default: every card);
    adds the ranks' kernel launches to ``counters``."""
    n = n or torch.cuda.device_count()
    rec = moe_phase(torch, np, name, n, args)
    for r in rec["ranks"]:
        for w, c in r["launches"].items():
            cw = counters.get(w)
            if cw is not None:
                cw.launches += c
                if hasattr(cw, "bf16_launches"):
                    cw.bf16_launches += r["bf16_launches"].get(w, 0)
    return rec


def moe_kernel_shapes(torch, fa):
    """K1, K3 and K4 against their plain versions at moe_gpt's attention
    shapes (B8 H12 at ep 4, B4 H12 at ep 2 x dp 2's rows, B8 H6 at ep 2 x
    tp 2's heads; S2048 D64, float32, causal, the packed qkv views), each
    timed beside SDPA's forward or backward with the same causal mask;
    not counted."""
    recs = []
    for B, H in ((4, 12), (8, 12), (8, 6)):
        recs.append(flash_phase(torch, fa, B, H, 2048, 64, "float32",
                                True, False, seed=2401 + B + H,
                                packed=True))
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            recs.append(bwd_phase(torch, fa, name, B, H, 2048, 64,
                                  "float32", True, False,
                                  seed=2411 + B + H, packed=True))
        torch.cuda.empty_cache()
    emit({"phase": "moe_kernel_shapes", **CARD, "rows": [
        {k: r[k] for k in ("phase", "B", "H", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by", "max_abs_err", "ok")}
        for r in recs]})
    return recs


# ------------------------------------------- multi-slice data parallelism

DCN_DIR = os.path.join(ROOT, "build", "chip_smoke_dcn")
# dcn_bert: fleet_bert's step (BERT-base, flash, bf16 AMP, Adam at
# noam_decay, dropout 0) at bench_bert_long's S2048 P64 over a global
# batch of 16 split over dcn_dp x dp dcn-major (4 rows a card on four
# cards), run_steps slabs of K 4 captured with the collectives inside
DCN_BERT = {"B": 16, "S": 2048, "P": 64, "K": 4, "seed": 250}
# the rank-mean losses of the flat and the dp 4 runs against the
# decomposed run's: the same program, rows and start, the grads summed
# in another order (float32 grads, bf16 activations: a weight a last
# ulp off can move a bf16 rounding); a bf16 tolerance, written before
# the first run on a card
DCN_LOSS_RTOL = 1e-2
DCN_LABEL_OPS = ("hier_allreduce", "c_coalesced_allreduce_sum")
# slice_drill: a narrow BERT (2 layers, hidden 256, S128 P8, flash,
# float32, dropout 0, Adam 1e-3) under train.SliceSupervisor over two
# slices, a global batch of 16, slabs of 2 steps, a checkpoint every
# slab; slice 1's beats are dropped at the exchanges of rounds 2-5, so it
# is lost after the window (round 4) and rejoins (round 7)
SLICE_DRILL = {"cfg": {"vocab_size": 1024, "hidden_size": 256,
                       "num_layers": 2, "num_heads": 4, "ffn_size": 1024,
                       "max_position": 512, "hidden_dropout": 0.0,
                       "attn_dropout": 0.0, "attn_mechanism": "flash"},
               "B": 16, "S": 128, "P": 8, "K": 2, "slabs": 10, "lr": 1e-3,
               "dead": [2, 6], "seed": 260}


def dcn_grids(n):
    """dcn_bert's runs on ``n`` cards: (tag, mesh axes,
    ``FLAGS_dcn_hierarchical``). Four cards: two slices of two with the
    decomposed sync, the same compiled program with the flat one, and dp
    4; elsewhere dp over every card (dcn_dp 1 through the same code)."""
    if n == 4:
        return [("hier", {"dcn_dp": 2, "dp": 2}, True),
                ("flat", {"dcn_dp": 2, "dp": 2}, False),
                ("dp4", {"dp": 4}, True)]
    return [(f"dp{n}", {"dp": n}, True)]


def _dcn_bert(torch, np, args, rank, n, place):
    """BERT-base (``DCN_BERT``) through ``with_data_parallel(mesh=...)``
    on each run of :func:`dcn_grids`, each from the same start on the
    same global batches: K eager steps against a run_steps slab (bitwise),
    a timed slab, a profiled slab (NCCL kernels by kind, idle), the
    device ms of the sync ops in an annotated eager step, the peak, and
    the gate's report; each run's captured steps freed before the
    next."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import mesh
    run = args["run"]
    B, S, P, K = run["B"], run["S"], run["P"], run["K"]
    cfg = bert_config(args.get("layers"), "flash", dropout=0.0,
                      max_position=max(S, 512))
    feeds = [bert.random_batch(cfg, B, S, P,
                               rng=np.random.default_rng(run["seed"] + i))
             for i in range(2)]
    exe = fluid.Executor(place)
    rec = {"B": B, "S": S, "P": P, "K": K, "layers": cfg.num_layers,
           "runs": {}}
    built, start = {}, None
    for tag, axes, hier in dcn_grids(n):
        grid = mesh.make_mesh(mesh.MeshConfig(**axes))
        c, nd = grid.coords()[mesh.DATA_AXIS], grid.axis_size(mesh.DATA_AXIS)
        rows = B // nd
        key = tuple(sorted(axes.items()))
        if key not in built:
            main, startup, out, _, _ = build_bert(cfg, rows, S, P)
            built[key] = (main, startup, out, fluid.CompiledProgram(
                main).with_data_parallel(loss_name=out["loss"].name,
                                         mesh=grid))
        main, startup, out, comp = built[key]
        fluid.set_flags({"FLAGS_dcn_hierarchical": hier})
        pool = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(
            exe.device) for k, v in bert.split_batch(f, c, nd).items()}
            for f in feeds]
        scope0 = fluid.Scope()
        exe.run(startup, scope=scope0)
        if start is None:
            start = {k: v.detach().clone() for k, v in scope0.items()
                     if isinstance(v, torch.Tensor)}
        for k, v in start.items():
            scope0.set(k, v.detach().clone())
        comp.hier_report = None
        r = _dp_train(torch, np, fluid, exe, comp, startup, out["loss"],
                      pool, K, DCN_LABEL_OPS, startup_scope=scope0)
        ops = comp.program.global_block().ops
        r.update({"axes": axes, "hierarchical": hier, "rows": rows,
                  "coords": grid.coords(),
                  "hier_ops": sum(o.type == "hier_allreduce" for o in ops),
                  "allreduce_buckets": sum(
                      o.type == "c_coalesced_allreduce_sum" for o in ops),
                  "gate": getattr(comp, "hier_report", None)})
        rec["runs"][tag] = r
        _release(torch, exe)
    fluid.set_flags({"FLAGS_dcn_hierarchical": True})
    return rec


def _drill_program(fluid, bert, cfg, rows, S, P, lr):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, rows, S, P)
        fluid.optimizer.AdamOptimizer(lr).minimize(out["loss"])
    return main, startup, out["loss"]


def _ckpt_by_slab(ckdir):
    """{slab: checkpoint directory} of a TrainCheckpoint directory."""
    from paddle_tpu_torch import train
    out = {}
    for d in sorted(os.listdir(ckdir)):
        st = os.path.join(ckdir, d, train.TRAIN_STATE_FILE)
        if os.path.isfile(st):
            with open(st) as f:
                out[json.load(f)["slab"]] = os.path.join(ckdir, d)
    return out


def _same_files(a, b):
    """Whether two checkpoint directories hold the same state files bit
    for bit (the manifest and train state aside)."""
    names = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    if names != sorted(f for f in os.listdir(b) if f.endswith(".npy")):
        return False
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                return False
    return bool(names)


def _slice_drill(torch, np, args, rank, n, place):
    """``train.SliceSupervisor`` over two slices of n/2 cards (one card:
    two virtual slices in a world of 1 on a fake clock, the control loop
    alone): the narrow BERT of ``SLICE_DRILL`` over the global slabs,
    slice 1's beats dropped (``train.slice_heartbeat``) at the exchanges
    of rounds ``dead``: the run shrinks to dcn_dp 1 on slice 0 and
    regrows. Then, on slice 0, the control: the checkpoint written at the
    shrink restored by a never-failed narrow ``TrainingSupervisor`` and
    run to the regrow's boundary, its state files bitwise the elastic
    run's there."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience, train
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import mesh
    run = args["run"]
    B, S, P, K, lr = run["B"], run["S"], run["P"], run["K"], run["lr"]
    cfg = bert.BertConfig(**run["cfg"])
    per = max(n // 2, 1)
    ck = os.path.join(DCN_DIR, "drill")
    if rank == 0:
        shutil.rmtree(DCN_DIR, ignore_errors=True)
        os.makedirs(DCN_DIR)
    mesh.barrier()
    slabs = []
    for i in range(run["slabs"]):
        fs = [bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(
            run["seed"] + i * K + j)) for j in range(K)]
        slabs.append({k: np.stack([f[k] for f in fs]) for k in fs[0]})
    _, _, loss = _drill_program(fluid, bert, cfg, B, S, P, lr)

    def build(width, devices):
        rows = B // (width * per) if n > 1 else B
        main, startup, _ = _drill_program(fluid, bert, cfg, rows, S, P, lr)
        grid = mesh.make_mesh(mesh.MeshConfig(dcn_dp=width if n > 1 else 1,
                                              dp=per), devices=devices)
        return {"executor": fluid.Executor(place),
                "program": fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name, mesh=grid),
                "startup_program": startup, "scope": fluid.Scope()}

    dead = range(*run["dead"])
    t = [0.0]
    box, widths, seen, losses = [], [], [], []

    def on_slab_end(slab_idx, step, fetches):
        widths.append(box[0].width)
        seen.append(slab_idx)
        losses.append(float(np.ravel(fetches[0])[-1]))
        if n == 1:         # two virtual slices: JAX's drill's beats
            t[0] += 1.0
            box[0].beat(0, now=t[0])
            if slab_idx not in dead:
                box[0].beat(1, now=t[0])

    def drop(point, ctx):
        if box[0].slice == 1 and ctx["round"] in dead:
            return resilience.FaultInjected("slice 1 is down")
        return None

    t0 = time.perf_counter()
    sup = train.SliceSupervisor(
        build, ck, slices=2, heartbeat_timeout_s=1.5, window=2,
        cooldown_s=0.0, clock=(lambda: t[0]) if n == 1
        else (lambda: box[0].rounds if box else 0),
        split=lambda slab, i, c: bert.split_batch(slab, i, c, axis=1),
        steps_per_run=K, checkpoint_every_n_slabs=1, max_to_keep=64,
        on_slab_end=on_slab_end)
    box.append(sup)
    with resilience.fault_injection("train.slice_heartbeat", exc=drop,
                                    times=-1):
        res = sup.run_slabs(slabs, fetch_list=[loss.name])
    rec = {"B": B, "S": S, "K": K, "slabs": run["slabs"],
           "slices": 2, "per_slice": per, "seconds": time.perf_counter() - t0,
           "dcn_dp": res["dcn_dp"], "idle": bool(res.get("idle")),
           "events": res["slice_events"], "widths": widths, "seen": seen,
           "losses": losses, "rounds": sup.rounds}
    if sup.supervisor is not None:
        sup.supervisor.executor.close()
    lost = [e for e in res["slice_events"] if e["event"] == "slice_lost"]
    back = [e for e in res["slice_events"] if e["event"] == "slice_rejoined"]
    mesh.activate(None)
    mesh.barrier()
    if rank < per and lost and back:
        # the control, on slice 0: narrow from the shrink's checkpoint to
        # the regrow's boundary
        by_slab = _ckpt_by_slab(ck)
        at_lost = widths.index(1) if 1 in widths else None
        at_back = len(widths) - widths[::-1].index(1) if 1 in widths \
            else None
        ctl = os.path.join(DCN_DIR, "control")
        if rank == 0:
            shutil.rmtree(ctl, ignore_errors=True)
            os.makedirs(ctl)
            shutil.copytree(by_slab[at_lost], os.path.join(
                ctl, os.path.basename(by_slab[at_lost])))
        mesh.barrier(mesh.make_mesh(mesh.MeshConfig(dp=per),
                                    devices=list(range(per)))
                     if n > 1 else None)
        narrow = build(1, list(range(per)) if n > 1 else None)

        def stop(slab_idx, step, fetches):
            if slab_idx == at_back:
                train.request_preemption("control")

        ctl_sup = train.TrainingSupervisor(
            narrow["executor"], narrow["program"], ctl,
            startup_program=narrow["startup_program"],
            scope=narrow["scope"], steps_per_run=K,
            checkpoint_every_n_slabs=1, max_to_keep=64, on_slab_end=stop)
        resumed = ctl_sup.resume() is not None
        m = narrow["program"].mesh
        try:
            ctl_sup.run_slabs([bert.split_batch(
                s, m.coords()[mesh.DATA_AXIS], m.axis_size(mesh.DATA_AXIS),
                axis=1) for s in slabs], fetch_list=[loss.name])
            preempted = False
        except train.PreemptedError:
            preempted = True
        train.clear_preemption()
        narrow["executor"].close()
        got = _ckpt_by_slab(ctl).get(at_back)
        rec["control"] = {
            "from_slab": at_lost, "to_slab": at_back, "resumed": resumed,
            "preempted": preempted,
            "bitwise": got is not None and at_back in by_slab
            and _same_files(got, by_slab[at_back])}
    mesh.activate(None)
    mesh.barrier()
    return rec


def _dcn_failures(name, ranks, args):
    import numpy as np
    bad = []
    if name == "slice_drill":
        r0 = ranks[0]
        events = [e["event"] for e in r0["events"]]
        if events != ["slice_lost", "slice_rejoined"]:
            bad.append(f"slice_drill: events {events}, not JAX's "
                       f"slice_lost then slice_rejoined")
        if r0["seen"] != list(range(1, r0["slabs"] + 1)):
            bad.append(f"slice_drill: slabs {r0['seen']} dropped or "
                       f"trained twice")
        ctl = r0.get("control")
        if not ctl or not (ctl["resumed"] and ctl["preempted"]
                           and ctl["bitwise"]):
            bad.append(f"slice_drill: the narrow run from the shrink's "
                       f"checkpoint is not the elastic run's: {ctl}")
        if any([e["event"] for e in r["events"]] != events for r in ranks):
            bad.append("slice_drill: the ranks applied other changes")
        if not all(math.isfinite(x) for x in r0["losses"]):
            bad.append(f"slice_drill: a loss is not finite {r0['losses']}")
        return bad
    r0 = ranks[0]
    want_k = r0["layers"]
    first = next(iter(r0["runs"]))
    ref = np.mean([r["runs"][first]["slab_losses"] for r in ranks], 0)
    for tag in r0["runs"]:
        runs = [r["runs"][tag] for r in ranks]
        if any(x["digest"] != runs[0]["digest"] for x in runs):
            bad.append(f"dcn_bert {tag}: parameters differ across ranks")
        for r in ranks:
            x = r["runs"][tag]
            if not x["slab_bitwise"]:
                bad.append(f"dcn_bert {tag}: rank {r['rank']}'s run_steps "
                           f"is not its eager steps {x['scope_diff']}")
            per = x["launches_per_step_run_steps"]
            bf = x["bf16_launches_per_step_run_steps"]
            if not args.get("cpu") and any(
                    per[k] != want_k or bf[k] != want_k
                    for k in DP_BERT_KERNELS):
                bad.append(f"dcn_bert {tag}: rank {r['rank']} launched "
                           f"{per} (bf16 {bf}) a step, not {want_k} of "
                           f"K1 and K2, all bf16")
        mean = np.mean([x["slab_losses"] for x in runs], 0)
        if not np.all(np.isfinite(mean)) or np.any(
                np.abs(mean - ref) > DCN_LOSS_RTOL * np.abs(ref)):
            bad.append(f"dcn_bert {tag}: rank-mean losses {mean.tolist()} "
                       f"off the {first} run's {ref.tolist()} (rtol "
                       f"{DCN_LOSS_RTOL})")
        gate = runs[0]["gate"]
        if tag == "hier" and (gate is None or gate["violations"]):
            bad.append(f"dcn_bert hier: the gate did not pass: {gate}")
        if tag == "flat" and (gate is None or not all(
                "shard is" in v or "do not beat" in v
                for v in gate["violations"])):
            bad.append(f"dcn_bert flat: the gate flagged more than the "
                       f"flat all-reduce: {gate}")
    return bad


def dcn_phase(torch, np, name, nproc, args=None, timeout=900):
    """One multi-slice phase at ``nproc`` ranks (one a card), checked and
    printed with the card, its power limit and N. Returns the record."""
    args = dict(args or {})
    if nproc == 1 and name == "dcn_bert" and not args.get("cpu"):
        args.setdefault("layers", ONE_CARD_LAYERS["fleet_bert"])
    args.setdefault("run", {"dcn_bert": DCN_BERT,
                            "slice_drill": SLICE_DRILL}[name])
    # a membership protocol out of step is a hang: the drill's launch
    # gets a short deadline
    ranks, launch = dp_launch(torch, name, nproc, args,
                              300 if name == "slice_drill" else timeout)
    rec = {"phase": name, **CARD, "N": nproc, "launch": launch}
    bad = _dcn_failures(name, ranks, args)
    r0 = ranks[0]
    if name == "slice_drill":
        rec.update({k: r0[k] for k in ("B", "S", "K", "slabs", "per_slice",
                                       "seconds", "dcn_dp", "events",
                                       "widths", "seen", "losses",
                                       "rounds")})
        rec["control"] = r0.get("control")
        rec["idle_at_end"] = [r["idle"] for r in ranks]
        rec["recovery_split"] = [
            {k: e.get(k) for k in ("event", "drain_s", "checkpoint_s",
                                   "rebuild_s", "restore_s", "capture_s",
                                   "recovery_s")} for e in r0["events"]]
    else:
        rec.update({k: r0[k] for k in ("B", "S", "P", "K", "layers")})
        rec["runs"] = {}
        for tag in r0["runs"]:
            runs = [r["runs"][tag] for r in ranks]
            slow = max(runs, key=lambda x: x["run_steps_ms_per_step"])
            row = {k: runs[0].get(k) for k in (
                "axes", "hierarchical", "rows", "hier_ops",
                "allreduce_buckets", "slab_losses", "eager_losses",
                "launches_per_step_run_steps",
                "bf16_launches_per_step_run_steps", "eager_op_device_ms",
                "eager_device_ms")}
            row.update({
                "rank_mean_losses": np.mean([x["slab_losses"] for x in runs],
                                            0).tolist(),
                "run_steps_ms_per_step": slow["run_steps_ms_per_step"],
                "ms_per_step_by_rank": [x["run_steps_ms_per_step"]
                                        for x in runs],
                "tokens_per_s_total": r0["B"] * r0["S"]
                / slow["run_steps_ms_per_step"] * 1e3,
                "eager_ms_per_step": max(x["eager_ms_per_step_median"]
                                         for x in runs),
                "capture_s": max(x["capture_s"] for x in runs),
                "peak_mem_gb_a_card": max(x.get("peak_mem_gb") or 0.0
                                          for x in runs)})
            if "profile" in runs[0]:
                prof = max(runs, key=lambda x: x["profile"]["wall_ms"])
                pr, K = prof["profile"], r0["K"]
                row.update({
                    "idle_share": 1.0 - pr["busy_ms"] / pr["wall_ms"],
                    "profiled_wall_ms_per_step": pr["wall_ms"] / K,
                    "nccl_kernels_per_step": len(pr["nccl_us"]) / K,
                    "nccl_busy_ms_per_step": pr["nccl_busy_ms"] / K,
                    "nccl_by_kind_per_step": {
                        k: [v[0] / K, v[1] / K]
                        for k, v in pr["nccl_by_kind"].items()},
                    "compute_busy_ms_per_step": pr["compute_busy_ms"] / K})
            gate = runs[0]["gate"]
            if gate is not None:
                row["gate"] = {k: gate[k] for k in (
                    "rows", "grad_bytes", "cross_slice_wire_bytes",
                    "flat_estimate_wire_bytes", "violations")}
                row["gate"]["violations"] = gate["violations"][:3] + (
                    [f"... {len(gate['violations'])} in all"]
                    if len(gate["violations"]) > 3 else [])
            rec["runs"][tag] = row
        hier, flat = rec["runs"].get("hier"), rec["runs"].get("flat")
        if hier and flat and hier.get("gate") and flat.get("gate"):
            rec["cross_slice_bytes_flat_over_hier"] = \
                flat["gate"]["cross_slice_wire_bytes"] / \
                hier["gate"]["cross_slice_wire_bytes"]
        rec["fabric"] = ("all four cards share one NVLink domain: the "
                         "hier/flat A/B shows what the decomposition "
                         "costs on one fabric, not what it saves across "
                         "slices") if nproc > 1 else None
    if nproc == 1:
        rec["note"] = ("one card: dcn_dp 1 through the same code; no "
                       "multi-slice was measured")
        print(f"{name}: {rec['note']}", flush=True)
    rec["ranks"] = ranks
    emit({k: v for k, v in rec.items() if k != "ranks"})
    if bad:
        raise AssertionError("; ".join(bad))
    return rec


def dcn_phases(torch, np, counters, name, n=None, args=None):
    """Multi-slice phase ``name`` at N = n (default: every card); adds the
    ranks' kernel launches to ``counters``."""
    n = n or torch.cuda.device_count()
    rec = dcn_phase(torch, np, name, n, args)
    for r in rec["ranks"]:
        for w, c in r["launches"].items():
            cw = counters.get(w)
            if cw is not None:
                cw.launches += c
                if hasattr(cw, "bf16_launches"):
                    cw.bf16_launches += r["bf16_launches"].get(w, 0)
    return rec


def dcn_kernel_shapes(torch, fa):
    """K1 and K2 against their plain versions at dcn_bert's attention on a
    card of four (B4 H12 S2048 D64 bf16, non-causal, padded-tail key
    bias), each timed beside SDPA's forward or backward; not counted."""
    recs = [flash_phase(torch, fa, 4, 12, 2048, 64, "bfloat16", False, True,
                        seed=2501, packed=False),
            bwd_phase(torch, fa, "flash_attention_bwd_single", 4, 12, 2048,
                      64, "bfloat16", False, True, seed=2502, packed=False)]
    emit({"phase": "dcn_kernel_shapes", **CARD, "rows": [
        {k: r[k] for k in ("phase", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_by", "max_abs_err", "ok")}
        for r in recs]})
    return recs


# ------------------------------------------------ the core layer surface

GPT_PROGRAMS = {"B": 8, "prompt": 128, "steps": 16, "span": 5, "bs": 16}


def _program(fluid, fn, *args):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn(*args)
    return main, startup, out


def _rel(torch, got, want):
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _paged_pools(torch, cfg, kv_dtype, ks, vs, tables, device):
    """Per layer (k pool, v pool, k scale, v scale) holding the prompt's
    keys and values through ``tables`` (block 0 the trash block)."""
    from paddle_tpu_torch.ops.decode_ops import paged_kv_cache_write
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    nb = int(tables.max()) + 1
    bs = GPT_PROGRAMS["bs"]
    out = []
    for k, v in zip(ks, vs):
        shape = (nb, cfg.num_heads, bs, cfg.d_head)
        pools = [torch.zeros(shape, dtype=dt, device=device)
                 for _ in range(2)]
        scales = [torch.zeros(shape[:3], device=device)
                  if kv_dtype == "int8" else None for _ in range(2)]
        zero = torch.zeros(k.shape[0], dtype=torch.int32, device=device)
        for pool, sc, src in zip(pools, scales, (k, v)):
            paged_kv_cache_write(pool, src, tables, zero, scale=sc)
        out.append((pools[0], pools[1], scales[0], scales[1]))
    return out


def _pool_feed(pools, quantized):
    feed = {}
    for i, (pk, pv, pks, pvs) in enumerate(pools):
        feed[f"cache_pk_{i}"], feed[f"cache_pv_{i}"] = pk, pv
        if quantized:
            feed[f"cache_pks_{i}"], feed[f"cache_pvs_{i}"] = pks, pvs
    return feed


def _pools_from(names, vals, quantized, L):
    by = dict(zip(names, vals))
    return [(by[f"cache_pk_{i}"], by[f"cache_pv_{i}"],
             by.get(f"cache_pks_{i}"), by.get(f"cache_pvs_{i}"))
            for i in range(L)]


def _clone_ms(torch, cuda, tensors):
    """ms wall of cloning ``tensors``, as a write op's clones cost: the
    first call's (the caching allocator may grow) and the median of the
    next 3."""
    def once():
        return _timed_wall(torch, cuda,
                           lambda: [x.clone() for x in tensors])[1]
    cold = once()
    return cold, sorted(once() for _ in range(3))[1]


def gpt_programs(torch, np, cfg=None, place=None, run=GPT_PROGRAMS,
                 seed=71):
    """GPT's generation programs (``models.gpt``'s builders, made of the
    registered decode ops) through the ``Executor`` against the port's
    ``GPT`` module over the same params, teacher-forced; the K1 and K5
    launches of the program runs; a greedy loop over the prefill and
    paged decode programs against ``GPTGenerator.generate``; ms a decode
    step through the program beside the module's eager and replayed
    step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import KVBlockPool
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    cfg = cfg or G.GPTConfig.base()
    B, P, T, SPAN, bs = (run[k] for k in ("B", "prompt", "steps", "span",
                                          "bs"))
    L = cfg.num_layers
    exe = fluid.Executor(place)
    dev = exe.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = init_params(cfg, seed)
    model = G.GPT(cfg, params, device=dev)
    max_len = P + T
    progs = {"prefill": _program(fluid, G.gpt_prefill, cfg, max_len),
             "decode": _program(fluid, G.gpt_decode_step, cfg, max_len),
             "verify": _program(fluid, G.gpt_verify_step_paged, cfg,
                                "fp32")}
    for kv in ("fp32", "bf16", "int8"):
        progs[f"paged_{kv}"] = _program(fluid, G.gpt_decode_step_paged,
                                        cfg, kv)
    scope = fluid.Scope()
    exe.run(progs["prefill"][1], scope=scope)
    scope_from_arrays(scope, {n: t.numpy() for n, t in params.items()})
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)
    pos_ids = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    last = np.full(B, P - 1, np.int32)
    forced = rng.integers(1, cfg.vocab_size, (B, T + SPAN)).astype(np.int32)

    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    rec = {"phase": "gpt_programs", **CARD, "rows": B, "prompt": P,
           "decode_steps": T, "verify_span": SPAN, "block_size": bs,
           "layers": L, "hidden": cfg.hidden_size, "errors": {}}
    errs, fails = rec["errors"], []

    def run_counted(name, feed, fetch):
        k1, k5 = fa.flash_attention_fwd.launches, pa.paged_attention.launches
        sync()
        t0 = time.perf_counter()
        vals = exe.run(progs[name][0], feed=feed, fetch_list=fetch,
                       scope=scope, return_numpy=False)
        sync()
        return vals, (time.perf_counter() - t0) * 1e3, \
            fa.flash_attention_fwd.launches - k1, \
            pa.paged_attention.launches - k5

    # prefill: the logits and the dense caches' prompt positions
    out = progs["prefill"][2]
    vals, _, k1, k5 = run_counted(
        "prefill", {"tokens": tokens, "pos_ids": pos_ids, "last_pos": last},
        [out["logits"]] + out["cache_k"] + out["cache_v"])
    ref, ks, vs = model.prefill(t(tokens), t(pos_ids), t(last))
    errs["prefill"] = max([_rel(torch, vals[0], ref)] + [
        _rel(torch, c[:, :, :P], r) for c, r in zip(vals[1:], ks + vs)])
    rec["k1_launches_per_prefill_run"] = k1
    rec["k5_launches_per_prefill_run"] = k5
    first = vals[0].argmax(-1)
    # a second (warm) prefill run, and what its write ops' clones of the
    # 2 L zero caches cost
    _, rec["prefill_program_ms"], _, _ = run_counted(
        "prefill", {"tokens": tokens, "pos_ids": pos_ids, "last_pos": last},
        [out["logits"]])
    rec["prefill_clone_cold_ms"], rec["prefill_clone_ms"] = _clone_ms(
        torch, cuda, vals[1:])
    rec["prefill_clone_bytes"] = sum(x.numel() * x.element_size()
                                     for x in vals[1:])
    if cuda and (k1 != L or k5):
        fails.append(f"prefill launched K1 {k1}, K5 {k5} (want {L}, 0)")

    # the dense decode program, teacher-forced
    out = progs["decode"][2]
    ck, cv = vals[1:1 + L], vals[1 + L:]
    mk, mv = [c.clone() for c in ck], [c.clone() for c in cv]
    worst = 0.0
    for s in range(T):
        pos = np.full(B, P + s, np.int32)
        feed = {"token": forced[:, s], "pos": pos}
        feed.update({f"cache_k_{i}": ck[i] for i in range(L)})
        feed.update({f"cache_v_{i}": cv[i] for i in range(L)})
        res, _, _, _ = run_counted("decode", feed, [out["logits"]]
                                   + out["cache_k"] + out["cache_v"])
        ck, cv = res[1:1 + L], res[1 + L:]
        want = model.decode_step(t(forced[:, s]), t(pos), mk, mv)
        worst = max(worst, _rel(torch, res[0], want))
    errs["decode_step"] = worst
    del ck, cv, mk, mv

    # the paged decode programs (fp32, bf16, int8), teacher-forced
    nblk = -(-(P + T + SPAN) // bs)
    tables = t((1 + np.arange(B * nblk)).reshape(B, nblk), torch.int32)
    rec["k5_launches_per_paged_step"] = {}
    rec["program_eager_ms_per_step"] = {}
    for kv in ("fp32", "bf16", "int8"):
        q = kv == "int8"
        out = progs[f"paged_{kv}"][2]
        pools = _paged_pools(torch, cfg, kv, ks, vs, tables, dev)
        mpools = [tuple(None if x is None else x.clone() for x in layer)
                  for layer in pools]
        worst, k5s, walls = 0.0, [], []
        for s in range(T):
            pos = np.full(B, P + s, np.int32)
            feed = {"token": forced[:, s], "pos": pos,
                    "block_tables": tables, **_pool_feed(pools, q)}
            res, ms, _, k5 = run_counted(f"paged_{kv}", feed,
                                         [out["logits"]] + out["cache_vars"])
            pools = _pools_from(out["cache_names"], res[1:], q, L)
            want = model.decode_step_paged(t(forced[:, s]), t(pos), tables,
                                           mpools)
            worst = max(worst, _rel(torch, res[0], want))
            k5s.append(k5)
            walls.append(ms)
        errs[f"decode_step_paged_{kv}"] = worst
        rec["k5_launches_per_paged_step"][kv] = k5s
        rec["program_eager_ms_per_step"][kv] = float(np.median(walls[1:]))
        if cuda and any(k != L for k in k5s):
            fails.append(f"paged {kv}: K5 launched {k5s} a step, not {L}")
        if kv == "fp32":
            fp32_pools, fp32_mpools = pools, mpools
            # what the write ops' clones of the fed pools cost a step
            tensors = [x for layer in pools for x in layer[:2]]
            rec["pool_clone_cold_ms_per_step"], \
                rec["pool_clone_ms_per_step"] = _clone_ms(torch, cuda,
                                                          tensors)
            rec["pool_clone_bytes_per_step"] = sum(
                x.numel() * x.element_size() for x in tensors)
        del pools, mpools

    # the paged verify program (S = SPAN: the gather route, no K5)
    out = progs["verify"][2]
    start = np.full(B, P + T, np.int32)
    span_ids = start[:, None] + np.arange(SPAN, dtype=np.int32)
    limit = np.full(B, SPAN, np.int32)
    feed = {"tokens": forced[:, T:T + SPAN], "pos_ids": span_ids,
            "start_pos": start, "limit": limit, "block_tables": tables,
            **_pool_feed(fp32_pools, False)}
    res, _, _, k5 = run_counted("verify", feed,
                                [out["logits"]] + out["cache_vars"])
    want = model.verify_step_paged(t(forced[:, T:T + SPAN]), t(span_ids),
                                   t(start, torch.int32),
                                   t(limit, torch.int32), tables,
                                   fp32_mpools)
    errs["verify_step_paged_fp32"] = _rel(torch, res[0], want)
    rec["k5_launches_verify_program"] = k5
    if k5:
        fails.append(f"the verify program launched K5 {k5} times")
    del fp32_pools, fp32_mpools, ks, vs

    # a greedy loop over the prefill and paged decode programs against
    # GPTGenerator.generate over the same params
    gen = GPTGenerator(cfg, params, max_len=P + T + 64, device=dev)
    prompts = [tokens[b] for b in range(B)]
    want = gen.generate(prompts, max_new_tokens=T, paged=True)
    pool = KVBlockPool(slots=B, num_layers=L, num_heads=cfg.num_heads,
                       d_head=cfg.d_head, max_seq_len=gen.max_len,
                       dtype="fp32", prefix_cache=False, device=dev)
    out = progs["prefill"][2]
    vals = exe.run(progs["prefill"][0], feed={
        "tokens": tokens, "pos_ids": pos_ids, "last_pos": last},
        fetch_list=[out["logits"]] + out["cache_k"] + out["cache_v"],
        scope=scope, return_numpy=False)
    for r in range(B):
        pool.alloc(r, P + T)
    pool.scatter_prefill(list(range(B)), [c[:, :, :P] for c in
                                          vals[1:1 + L]],
                         [c[:, :, :P] for c in vals[1 + L:]], P)
    tok = vals[0].argmax(-1).to(torch.int32).cpu().numpy()
    got = [tok]
    out = progs["paged_fp32"][2]
    names = [n for i in range(L) for n in (f"cache_pk_{i}",
                                           f"cache_pv_{i}")]
    for s in range(T - 1):
        pos = np.full(B, P + s, np.int32)
        for r in range(B):
            pool.ensure(r, P + s)
        feed = {"token": tok, "pos": pos,
                "block_tables": pool.device_tables(),
                **dict(zip(names, pool.tensors()))}
        res = exe.run(progs["paged_fp32"][0], feed=feed,
                      fetch_list=[out["logits"]] + out["cache_vars"],
                      scope=scope, return_numpy=False)
        by = dict(zip(out["cache_names"], res[1:]))
        for n, dst in zip(names, pool.tensors()):
            dst.copy_(by[n])
        tok = res[0].argmax(-1).to(torch.int32).cpu().numpy()
        got.append(tok)
    got = np.stack(got, 1)
    rec["greedy_tokens_equal_generate"] = bool(all(
        np.array_equal(got[b], want[b]) for b in range(B)))
    rec["greedy_token_agreement"] = float(np.mean(
        [np.mean(got[b] == want[b]) for b in range(B)]))
    if not rec["greedy_tokens_equal_generate"]:
        fails.append(f"the programs' greedy tokens are not generate's "
                     f"(agreement {rec['greedy_token_agreement']})")
    del pool

    # the module's decode step at this shape, eager and replayed
    kv, tok, pos = prefilled(torch, np, gen, prompts, True, room=T + 8)
    dec = gen.new_decoder()
    rows = tok.shape[0]                          # the row bucket
    greedy, topk = np.zeros(rows, np.float32), np.zeros(rows, np.int32)
    dec.run(tok, pos, greedy, topk, kv)          # capture
    for name, fn in (("module_replay_ms_per_step", dec.run),
                     ("module_eager_ms_per_step", dec.eager)):
        sync()
        t0 = time.perf_counter()
        for _ in range(8):
            fn(tok, pos, greedy, topk, kv)
        sync()
        rec[name] = (time.perf_counter() - t0) * 1e3 / 8
    del kv, dec
    gen.release()
    for name, e in errs.items():
        # both sides quantize a bf16/int8 pool alike and read it through
        # K5: every pool is held at fp32's limit
        tol = 1e-4
        if not e <= tol:
            fails.append(f"{name}: logits {e:.3g} of max |ref| from the "
                         f"module's (limit {tol})")
    rec["ok"] = not fails
    emit(rec)
    if fails:
        raise AssertionError(f"gpt_programs: {fails}")
    return rec


BOOK_VGG = {"B": 128, "hw": 32, "classes": 10, "lr": 1e-3, "K": 4}


def book_vgg16(torch, np, place=None, run=BOOK_VGG, seed=61):
    """vgg16_bn_drop on CIFAR-10's shape at the book's batch: K eager
    steps against one run_steps slab of K from copies of one scope
    (losses and scope bitwise, dropout on), the next slab's mean loss
    below the first's; ms a step
    both ways, images/s, device ms a step, idle share, kernels a replay,
    peak memory, capture seconds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.book import vgg16_bn_drop
    B, hw, K = run["B"], run["hw"], run["K"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, _ = vgg16_bn_drop(fluid, B, hw, run["classes"])
        fluid.optimizer.Adam(run["lr"]).minimize(loss)
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rng = np.random.default_rng(seed)
    feed = {"image": torch.from_numpy(rng.standard_normal(
                (B, 3, hw, hw)).astype(np.float32)).to(exe.device),
            "label": torch.from_numpy(rng.integers(
                0, run["classes"], (B, 1)).astype(np.int64)).to(exe.device)}
    slab = {n: torch.stack([v] * K) for n, v in feed.items()}
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    del scope0
    ops = main.global_block().ops
    rec = {"phase": "book_vgg16", **CARD, "B": B, "image": hw,
           "classes": run["classes"], "K": K, "optimizer": "Adam",
           "lr": run["lr"], "dtype": "float32",
           "conv2d": sum(op.type == "conv2d" for op in ops),
           "batch_norm": sum(op.type == "batch_norm" for op in ops),
           "dropout": sum(op.type == "dropout" for op in ops),
           "flops_per_step": conv_fc_flops_per_step(main)}
    base = _peak_base(torch, cuda)
    eager, wall = [], []
    for _ in range(K):
        lv, ms = _timed_wall(torch, cuda, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=sA)[0])
        eager.append(lv)
        wall.append(ms)
    got, first = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=[loss], scope=sB)[0])
    diff = scope_diff(torch, sA, sB)
    later, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=[loss], scope=sB)[0])
    rec.update({
        "eager_losses": [float(x) for x in eager],
        "run_steps_losses": [float(x) for x in got],
        "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
        "scope_bitwise": not diff, "scope_diff": diff[:8],
        # steps K+1..2K (the timed slab) against steps 1..K: dropout
        # makes single steps noisy
        "next_slab_losses": [float(x) for x in later],
        "loss_falls": bool(np.mean(later) < np.mean(got)),
        "eager_ms_per_step": wall,
        "eager_ms_per_step_median": float(np.median(wall[1:])),
        "run_steps_ms_per_step": ms / K,
        "first_run_steps_s": first / 1e3,
        "capture_s": (first - ms) / 1e3,
        "peak_gb": _peak_from(torch, cuda, base)})
    rec["images_per_s_run_steps"] = B / rec["run_steps_ms_per_step"] * 1e3
    rec["images_per_s_eager"] = B / rec["eager_ms_per_step_median"] * 1e3
    rec["tflops_run_steps"] = rec["flops_per_step"] / \
        rec["run_steps_ms_per_step"] / 1e9
    if cuda:
        dev, n = profiled_launches(torch, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[loss], scope=sB))
        rec["device_ms_per_step_run_steps"] = dev / K
        rec["kernels_per_replay"] = n / K
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["device_ms_per_step_eager"] = profiled_ms(
            torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=sA))
        rec["idle_share_eager"] = 1 - rec["device_ms_per_step_eager"] / \
            rec["eager_ms_per_step_median"]
        rec["stochastic_call_sites"] = len(_captured(exe)._sites)
    rec["ok"] = rec["losses_bitwise"] and not diff and rec["loss_falls"] \
        and bool(np.isfinite(got).all())
    del sA, sB
    _release(torch, exe)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"book_vgg16: {rec}")
    return rec


def book_models(torch, np, place=None, steps=3):
    """Each of ``models.book.BOOK_BUILDS`` 3 steps on ``place`` (the card) and on
    the CPU from one startup (the card's scope a copy of the CPU's):
    every step's fetches within 1e-4 of max |ref| of the CPU's; ms a
    step on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.book import BOOK_BUILDS, book_feeds
    cpu = fluid.Executor(fluid.CPUPlace())
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    rec = {"phase": "book_models", **CARD, "steps": steps, "models": {}}
    fails = []
    feeds = book_feeds()
    for name, build in BOOK_BUILDS.items():
        feed = feeds[name]
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        sc = fluid.Scope()
        cpu.run(startup, scope=sc)
        sg = fluid.Scope()
        for n, v in sc.items():
            sg.set(n, v.to(exe.device) if isinstance(v, torch.Tensor)
                   else v)
        ref = [cpu.run(main, feed=feed, fetch_list=fetch, scope=sc)
               for _ in range(steps)]
        got, wall = [], []
        for _ in range(steps):
            out, ms = _timed_wall(torch, cuda, lambda: exe.run(
                main, feed=feed, fetch_list=fetch, scope=sg))
            got.append(out)
            wall.append(ms)
        err = max(float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
                  for gs, rs in zip(got, ref) for g, r in zip(gs, rs))
        rec["models"][name] = {
            "losses": [float(g[0]) for g in got],
            "cpu_losses": [float(r[0]) for r in ref],
            "max_rel_err": err, "ms_per_step": wall,
            "ms_per_step_median": float(np.median(wall[1:]))}
        if not err <= 1e-4:
            fails.append(f"{name}: {err:.3g} of max |ref| from the CPU's")
    rec["ok"] = not fails
    emit(rec)
    if fails:
        raise AssertionError(f"book_models: {fails}")
    return rec


# ------------------------------------------------------------- observability

OBS_TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_trace")
# the spans every traced generate request must hold
OBS_SPANS = ("client/send", "serving/handle", "serving/queue",
             "serving/prefill", "serving/decode", "serving/reply")
# the most of a FLAGS_profile_ops table of BERT-base's ~1090 ops that
# its slowest row may take: a row that paid for the caching allocator
# taking memory from the card stands out (229 of 1131 ms on an H100
# 80GB HBM3 with the allocator cold, 1.3-2.4% warm)
PROFILE_OPS_TOP_SHARE = 0.05
# the trace rates of the telemetry's cost passes, alternating so a drift
# of the host falls on both
COST_RATES = (0.0, 1.0, 1.0, 0.0, 0.0, 1.0)
_PROM_LINE = None


def parse_prometheus(text):
    """Prometheus text exposition (format 0.0.4) as ``{name: [(labels,
    value)]}``; raises ValueError on a line that is not a comment, a
    blank or a sample."""
    import re
    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = re.compile(
            r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = _PROM_LINE.match(ln)
        if m is None:
            raise ValueError(f"not a Prometheus sample line: {ln!r}")
        labels = dict(label.findall(m.group(3) or ""))
        out.setdefault(m.group(1), []).append((labels, float(m.group(4))))
    return out


def prom_value(parsed, name, **labels):
    """The value of ``name`` whose labels include ``labels`` (0.0 when the
    series is absent)."""
    for lab, v in parsed.get(name, ()):
        if all(lab.get(k) == v2 for k, v2 in labels.items()):
            return v
    return 0.0


def obs_traffic(np, server, prompts, new, clients, sample=None):
    """``prompts`` from ``clients`` concurrent wire clients (request i on
    client i % clients); ``sample()`` is called every 5 ms while they
    run. Returns ({i: tokens}, wall s)."""
    from paddle_tpu_torch.serving import Client
    got, errors = {}, []

    def client(idxs):
        try:
            with Client(server.endpoint, timeout=600) as c:
                for i in idxs:
                    got[i] = c.generate(prompts[i], new)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(
        range(c, len(prompts), clients),)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        if sample is not None:
            sample()
        time.sleep(0.005)
        if time.perf_counter() - t0 > 900:
            break
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors \
            or len(got) != len(prompts):
        raise AssertionError(f"observability clients failed: {errors}")
    return got, wall


def _stage_mean_ms(hist, before):
    """Mean ms of ``hist``'s observations since ``before`` (its
    ``_state()`` then)."""
    _, n, s, _ = hist._state()
    return (s - before[2]) / max(n - before[1], 1) * 1e3


def trace_gates(spans, n_requests):
    """The traced requests' spans grouped by trace: ``n_requests`` traces
    with a ``serving/handle`` span, each holding every :data:`OBS_SPANS`
    name, each child span inside its parent. ``serving/reply`` must start
    inside its parent (``client/send``); its end is read by the server's
    thread after the send returns, which can come after the client has
    read the reply and closed its span, so how far it runs past is
    reported, not gated. Returns (record, failures)."""
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s[4], []).append(s)
    reqs = {t: ss for t, ss in by_trace.items()
            if any(s[0] == "serving/handle" for s in ss)}
    fails = []
    if len(reqs) != n_requests:
        fails.append(f"{len(reqs)} traced requests, not {n_requests}")
    missing, outside, decode, late = [], [], [], [0.0]
    for tid, ss in reqs.items():
        names = {s[0] for s in ss}
        if not set(OBS_SPANS) <= names:
            missing.append(sorted(set(OBS_SPANS) - names))
        decode.append(sum(s[0] == "serving/decode" for s in ss))
        by_id = {s[5]: s for s in ss}
        for s in ss:
            p = by_id.get(s[6])
            if p is None:
                continue
            end = s[2]
            if s[0] == "serving/reply":
                late.append(max(s[2] - p[2], 0.0))
                end = s[1]
            if not (p[1] <= s[1] and end <= p[2]):
                outside.append((s[0], p[0]))
    if missing:
        fails.append(f"traces lack spans: {missing[:4]}")
    if outside:
        fails.append(f"child spans outside their parents: {outside[:4]}")
    return {"traced_requests": len(reqs),
            "spans": sum(len(ss) for ss in reqs.values()),
            "decode_spans_per_request": [min(decode or [0]),
                                         max(decode or [0])],
            "children_outside_parent": len(outside),
            "reply_end_past_client_send_max_s": max(late)}, fails


TRACE_MARKERS = 32


def trace_markers(torch, cuda):
    """:data:`TRACE_MARKERS` short ``spin_kernel`` launches, then a sync:
    one run of them opens a traced window and another closes it. After
    many earlier traces in the process the tracer drops the first
    records of a new one (23-27 of the 32 leading markers on an H100 late
    in this script; none when the phase ran alone), so the leading run
    takes that loss in place of the window's kernels, and
    :func:`marker_records` shows how much of it there was."""
    if cuda:
        for _ in range(TRACE_MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def marker_records(torch, prof):
    """[markers before, markers after] the window's other kernel records
    in a stopped ``torch.profiler`` session (each of
    :data:`TRACE_MARKERS` when none was lost)."""
    marks, first, last = [], None, None
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith(("Memcpy", "Memset")):
            continue
        t = e.time_range.start
        if "spin_kernel" in e.name:
            marks.append(t)
        else:
            first = t if first is None else min(first, t)
            last = t if last is None else max(last, t)
    if first is None:
        return [len(marks), 0]
    return [sum(t < first for t in marks), sum(t > last for t in marks)]


def count_kernel_records(torch, prof, names):
    """{match: kernel records whose name holds it} and the count of all
    kernel records in a stopped ``torch.profiler`` session."""
    got = dict.fromkeys(names, 0)
    total = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith(("Memcpy", "Memset")):
            continue
        total += 1
        for m in names:
            if m in e.name:
                got[m] += 1
    return got, total


def observability_phase(torch, np, cfg, fa, pa, device=None, max_len=2048,
                        new=32, lo=64, hi=1024, clients=8, tries=3,
                        cost_reps=16):
    """The observability core on GPT-base generation serving (a paged
    fp32 pool, 8 decode slots, max_len 2048, as ``server_full`` builds
    its server; speculative decoding, chunked prefill and the prefix
    cache left off so each request takes the K1 prefill and K5 decode
    steps): the serving path's 8 prompts (``pr1_prompts``) twice, 16
    requests from ``clients`` wire clients, once at
    ``FLAGS_trace_sample_rate`` 0 to capture the decode graphs, then:

    1. at rate 1: every request's trace holds client/send,
       serving/handle, queue, prefill, decode and reply spans under one
       trace id, each child inside its parent; the ``metrics`` wire op
       parses as Prometheus text, its ``serving_tokens_generated_total``
       grew by the tokens the clients received, ``device_flops_total
       {where="decode"}`` grew, the decode ratios over the pass (the
       counters' FLOPs and bytes over their device ms, against the peaks:
       not the gauges, which clamp at 1) and the gauges lie in (0, 1.05],
       the server's SLO rule states are exported; ``debug_dump`` returns
       events; the kvpool gauges were non-zero while requests were in
       flight;
    2. the telemetry's cost: the 16 requests ``cost_reps`` times over
       (256, several seconds a pass) from the same ``clients`` clients,
       a pass at each rate of :data:`COST_RATES` in turn; the median and
       range at each rate of tokens/s, decode ms a step (the replay's
       stage time) and the whole decode-loop step. No gate;
    3. at rate 1 under ``profiler.profiler(state="All", trace_dir=...)``,
       the traffic between two runs of :func:`trace_markers`: the device
       trace holds one K5 (``paged_split_kernel``) record per
       K5 launch the counter saw in the window and one K1 record per K1
       launch (a trace that lost records is taken again, up to ``tries``
       in all; one never shows more), and ``tools/timeline.py`` renders
       the span JSON ``stop_profiler`` wrote."""
    import shutil

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.flags import flag, set_flags
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.observability import (default_registry,
                                                render_metrics)
    from paddle_tpu_torch.observability import utilization as util
    from paddle_tpu_torch.serving import Client, InferenceServer
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    cuda = gen.device.type == "cuda"
    prompts = pr1_prompts(np, cfg, lo, hi) * 2
    n = len(prompts)
    rec = {"phase": "observability", "requests": n, "clients": clients,
           "slots": 8, "new_tokens": new, "max_len": max_len,
           "kv": "paged fp32"}
    fails = []
    saved = flag("trace_sample_rate")
    server = InferenceServer(generator=gen, decode_slots=8, paged=True)
    hists = server.stats_sink.hist
    fams = default_registry()._families
    in_use = fams["kvpool_blocks_in_use_count"]
    occ = fams["kvpool_occupancy_ratio"]
    pool = server.gen_engine.pool.name
    peak = {"blocks": 0.0, "occupancy": 0.0}

    def sample():
        peak["blocks"] = max(peak["blocks"], in_use.value((pool,)))
        peak["occupancy"] = max(peak["occupancy"], occ.value((pool,)))

    def run(rate, sampler=None, reqs=prompts):
        set_flags({"trace_sample_rate": rate})
        before = {s: hists[s]._state() for s in ("decode", "token")}
        got, wall = obs_traffic(np, server, reqs, new, clients, sampler)
        return got, {"rate": rate, "requests": len(reqs),
                     "tokens_per_s": sum(len(t) for t in got.values())
                     / wall, "wall_s": wall,
                     "decode_ms_per_step": _stage_mean_ms(
                         hists["decode"], before["decode"]),
                     "loop_step_ms": _stage_mean_ms(hists["token"],
                                                    before["token"])}

    passes = []
    try:
        server.start()
        obs_traffic(np, server, prompts, new, clients)      # captures
        # -- 1: traced, scraped
        profiler.reset_profiler()
        util.reset_windows()
        before = parse_prometheus(render_metrics())
        got, _ = run(1.0, sample)
        with Client(server.endpoint, timeout=120) as c:
            text = c.metrics()
            dump = c.debug_dump()
        set_flags({"trace_sample_rate": 0.0})
        after = parse_prometheus(text)
        spans = [s for s in profiler._spans if len(s) >= 7]
        trace_rec, tf = trace_gates(spans, n)
        fails += tf
        rec["trace"] = trace_rec
        tokens = sum(len(t) for t in got.values())
        grown = prom_value(after, "serving_tokens_generated_total") \
            - prom_value(before, "serving_tokens_generated_total")
        flops, nbytes, ms = (
            prom_value(after, fam, where="decode")
            - prom_value(before, fam, where="decode")
            for fam in ("device_flops_total", "device_hbm_bytes_total",
                        "device_compute_ms_total"))
        mfu = prom_value(after, "device_mfu_ratio", where="decode")
        bw = prom_value(after, "device_hbm_bw_util_ratio", where="decode")
        pf, pb = util.peak_flops(), util.hbm_peak()
        # the gauges clamp at 1: the counters show an overcount
        raw = (None, None) if not (ms > 0 and pf and pb) else \
            (flops / (ms / 1e3) / pf, nbytes / (ms / 1e3) / pb)
        rules = [r.name for r in server.slo_monitor.rules]
        states = {r: [v for lab, v in after.get("slo_rule_state", ())
                      if lab.get("scope") == server.endpoint
                      and lab.get("rule") == r] for r in rules}
        rec.update({
            "metrics_families": len(after), "tokens_received": tokens,
            "tokens_generated_grew": grown,
            "decode_flops_grew": flops, "decode_bytes_grew": nbytes,
            "decode_compute_ms_grew": ms,
            "decode_mfu_from_counters": raw[0],
            "decode_hbm_bw_util_from_counters": raw[1],
            "decode_mfu_ratio": mfu, "decode_hbm_bw_util_ratio": bw,
            "prefill_mfu_ratio": prom_value(after, "device_mfu_ratio",
                                            where="prefill"),
            "peak_flops": pf, "hbm_peak": pb,
            "slo_rule_states": states,
            "debug_dump_events": len(dump.get("events", ())),
            "kvpool_blocks_in_use_peak": peak["blocks"],
            "kvpool_occupancy_peak": peak["occupancy"]})
        if grown != tokens:
            fails.append(f"serving_tokens_generated_total grew by {grown}, "
                         f"the clients received {tokens}")
        if not flops > 0:
            fails.append("device_flops_total{where=decode} did not grow")
        if not all(r is not None and 0 < r <= 1.05
                   for r in (*raw, mfu, bw)):
            fails.append(f"decode mfu {raw[0]} (gauge {mfu}), hbm bw "
                         f"{raw[1]} (gauge {bw}) not in (0, 1.05]")
        if not rules or any(len(v) != 1 for v in states.values()):
            fails.append(f"SLO rule states not exported: {states}")
        if not rec["debug_dump_events"]:
            fails.append("debug_dump returned no events")
        if not (peak["blocks"] > 0 and peak["occupancy"] > 0):
            fails.append(f"kvpool gauges stayed 0 in flight: {peak}")
        # -- 2: the telemetry's cost, rates alternating
        for rate in COST_RATES:
            profiler.reset_profiler()
            passes.append(run(rate, reqs=prompts * cost_reps)[1])
        set_flags({"trace_sample_rate": 0.0})
        profiler.reset_profiler()
        # -- 3: the same traffic under the device tracer
        prof_json = os.path.join(OBS_TRACE_DIR, "spans.json")
        shutil.rmtree(OBS_TRACE_DIR, ignore_errors=True)
        os.makedirs(OBS_TRACE_DIR)
        seen = []
        for _ in range(tries):
            k5, k1 = pa.paged_attention.launches, \
                fa.flash_attention_fwd.launches
            profiler.reset_profiler()
            with profiler.profiler(state="All" if cuda else "CPU",
                                   trace_dir=OBS_TRACE_DIR,
                                   profile_path=prof_json):
                trace_markers(torch, cuda)
                run(1.0)
                trace_markers(torch, cuda)
            set_flags({"trace_sample_rate": 0.0})
            k5 = pa.paged_attention.launches - k5
            k1 = fa.flash_attention_fwd.launches - k1
            prof = profiler.last_device_trace()["profile"]
            got_n, total = count_kernel_records(
                torch, prof, ("paged_split_kernel", K1_KERNEL))
            seen.append({"k5_records": got_n["paged_split_kernel"],
                         "k5_launches": k5, "k1_records": got_n[K1_KERNEL],
                         "k1_launches": k1, "kernel_records": total,
                         "markers": marker_records(torch, prof)
                         if cuda else None})
            s = seen[-1]
            if (s["k5_records"], s["k1_records"]) == (k5, k1) \
                    or s["k5_records"] > k5 or s["k1_records"] > k1:
                break
        rec["device_trace"] = seen
        s = seen[-1]
        if cuda and ((s["k5_records"], s["k1_records"]) !=
                     (s["k5_launches"], s["k1_launches"])
                     or not s["k5_launches"] or not s["k1_launches"]):
            fails.append(f"device trace records vs launches: {seen}")
        out = os.path.join(OBS_TRACE_DIR, "timeline.json")
        r = subprocess.run([sys.executable,
                            os.path.join(ROOT, "tools", "timeline.py"),
                            "--profile_path", prof_json, "--timeline_path",
                            out], capture_output=True, text=True,
                           timeout=300)
        events = 0
        if r.returncode == 0:
            with open(out) as f:
                events = sum(e.get("ph") == "X"
                             for e in json.load(f)["traceEvents"])
        rec["timeline_events"] = events
        if r.returncode or not events:
            fails.append(f"tools/timeline.py: rc {r.returncode} "
                         f"{r.stderr[-400:]}")
    finally:
        server.stop()
        set_flags({"trace_sample_rate": saved})
        profiler.reset_profiler()
        gen.release()
    rec["passes"] = passes
    keys = ("tokens_per_s", "decode_ms_per_step", "loop_step_ms")
    cost = {}
    for rate in sorted(set(COST_RATES)):
        got = {k: [p[k] for p in passes if p["rate"] == rate] for k in keys}
        cost[f"rate{rate:g}"] = {
            k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in got.items()}
    if {"rate0", "rate1"} <= set(cost):
        med = {r: {k: cost[r][k]["median"] for k in keys}
               for r in ("rate0", "rate1")}
        cost["tokens_per_s_rate1_over_rate0"] = \
            med["rate1"]["tokens_per_s"] / med["rate0"]["tokens_per_s"]
        cost["tokens_per_s_rate0_range_over_median"] = \
            (cost["rate0"]["tokens_per_s"]["max"]
             - cost["rate0"]["tokens_per_s"]["min"]) \
            / med["rate0"]["tokens_per_s"]
        for k in keys[1:]:
            cost[f"{k}_rate1_minus_rate0"] = med["rate1"][k] - med["rate0"][k]
    rec["telemetry_cost"] = cost
    rec["ok"] = not fails
    card_line(rec)
    if fails:
        raise AssertionError(f"observability: {fails}")
    return rec


def obs_bert_probe(torch, np, fluid, exe, main, slab, fetch, scope, feed,
                   cfg, B, S, P, K, slabs=3):
    """The live gauges of a captured BERT-base step (``_bert_adam_ab``'s
    executor: bench_bert_long's shape, flash K1/K2, bf16 AMP) and one
    eager step under ``FLAGS_profile_ops``:

    - ``slabs`` more slabs of K, each between a pair of CUDA events on
      the stream: ``device_flops_total{where="train"}`` grows by exactly
      K times the step's estimated cost, K1 and K2 by K per layer (the
      replaying code counts, not the captured callable), and
      ``device_compute_ms_total{where="train"}`` by the slab's device ms
      within 10%; ``device_mfu_ratio{where="train"}`` times the card's
      peak over the phase's own TFLOP/s (bench.py's formula over the
      same device ms) lies in [0.67, 1.5];
    - one eager ``Executor.run`` from a copy of the scope with
      ``FLAGS_profile_ops`` 0 and another with 1: the fetches and the
      whole scope bitwise; the measured table holds flash_attention and
      its grad (their ranks by ms), and no row takes more than
      :data:`PROFILE_OPS_TOP_SHARE` of its total (one untimed profiled
      step on a third copy comes first, so the allocator holds what the
      walk needs); its total over the captured step's device ms (the
      walk waits for the card after each op, so the host's time per op
      adds to the device's) and ``memory_profile``'s static peak beside
      the step's ``max_memory_allocated`` are reported, no gate."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.observability import (default_registry,
                                                last_op_profile)
    from paddle_tpu_torch.observability import utilization as util
    cuda = exe.device.type == "cuda"
    fa_mod = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    k1, k2 = fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd_single
    fams = default_registry()._families
    L = cfg.num_layers
    rec, fails = {}, []
    util.reset_windows()
    rows = []
    for _ in range(slabs):
        before = (fams["device_flops_total"].value(("train",)),
                  fams["device_compute_ms_total"].value(("train",)),
                  k1.launches, k2.launches)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
        t0 = time.perf_counter()
        exe.run_steps(main, feed=slab, fetch_list=fetch, scope=scope)
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        rows.append({
            "slab_device_ms": ms,
            "flops_grew": fams["device_flops_total"].value(("train",))
            - before[0],
            "compute_ms_grew": fams["device_compute_ms_total"].value(
                ("train",)) - before[1],
            "k1_grew": k1.launches - before[2],
            "k2_grew": k2.launches - before[3]})
    step_cost = [c for k, c in exe._costs.items() if c][-1]
    rec["step_cost"] = step_cost
    rec["slabs"] = rows
    for r in rows:
        if r["flops_grew"] != K * step_cost["flops"]:
            fails.append(f"device_flops_total grew {r['flops_grew']}, not "
                         f"{K} x {step_cost['flops']}")
        if cuda and (r["k1_grew"], r["k2_grew"]) != (K * L, K * L):
            fails.append(f"K1/K2 grew {(r['k1_grew'], r['k2_grew'])} in "
                         f"a slab of {K}, not {K * L} each")
        if cuda and not abs(r["compute_ms_grew"] - r["slab_device_ms"]) \
                <= 0.1 * r["slab_device_ms"]:
            fails.append(f"device_compute_ms_total grew "
                         f"{r['compute_ms_grew']} over a slab of "
                         f"{r['slab_device_ms']} device ms")
    u = util.utilization("train")
    ms_step = float(np.median([r["slab_device_ms"] for r in rows])) / K
    formula = bert_train_flops_per_sample(cfg, S, P) * B
    phase_flops_per_s = formula / (ms_step / 1e3)
    peak = util.peak_flops()
    rec.update({"train_mfu_ratio": u["mfu"],
                "train_hbm_bw_util_ratio": u["hbm_bw_util"],
                "device_ms_per_step": ms_step,
                "formula_flops_per_step": formula,
                "estimated_flops_per_step": step_cost["flops"],
                "estimate_over_formula": step_cost["flops"] / formula,
                "phase_tflops": phase_flops_per_s / 1e12,
                "peak_tflops": None if peak is None else peak / 1e12})
    if cuda:
        ratio = None if peak is None else u["mfu"] * peak / phase_flops_per_s
        rec["gauge_over_formula"] = ratio
        if ratio is None or not 0.67 <= ratio <= 1.5:
            fails.append(f"train MFU gauge {u['mfu']} x peak {peak} over "
                         f"the phase's {phase_flops_per_s:.4g} FLOP/s = "
                         f"{ratio}, not in [0.67, 1.5]")
    # one eager step with FLAGS_profile_ops off and on, from copies
    sA, sW, sB = (copied_scope(torch, fluid, scope) for _ in range(3))
    _sync(torch, exe)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    off = exe.run(main, feed=feed, fetch_list=fetch, scope=sA)
    _sync(torch, exe)
    rec["eager_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
    if cuda:
        rec["eager_step_peak_bytes"] = torch.cuda.max_memory_allocated() \
            - base
        rec["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    set_flags({"profile_ops": 1})
    try:
        exe.run(main, feed=feed, fetch_list=fetch, scope=sW)    # warm-up
        rec["warm_up_measured_total_ms"] = last_op_profile()["total_ms"]
        on = exe.run(main, feed=feed, fetch_list=fetch, scope=sB)
    finally:
        set_flags({"profile_ops": 0})
    diff = scope_diff(torch, sA, sB)
    rec["profile_ops_bitwise"] = all(np.array_equal(a, b)
                                     for a, b in zip(off, on)) and not diff
    if not rec["profile_ops_bitwise"]:
        fails.append(f"FLAGS_profile_ops changed the step: {off} vs {on}, "
                     f"scope diff {diff[:8]}")
    prof = last_op_profile()
    ranked = sorted(prof["rows"], key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in ranked)
    rank = {}
    for i, r in enumerate(ranked):
        rank.setdefault(r["type"], {"rank": i, "ms": r["ms"],
                                    "share": r["ms"] / total})
    rec["measured_ops"] = len(ranked)
    rec["measured_total_ms"] = prof["total_ms"]
    rec["measured_over_step_device_ms"] = prof["total_ms"] / ms_step
    rec["top_ops"] = [(r["type"], r["ms"]) for r in ranked[:8]]
    rec["top_row_share"] = ranked[0]["ms"] / total
    if cuda and not rec["top_row_share"] <= PROFILE_OPS_TOP_SHARE:
        fails.append(f"the measured table's slowest row takes "
                     f"{rec['top_row_share']:.3f} of its {total} ms, over "
                     f"{PROFILE_OPS_TOP_SHARE}: {rec['top_ops']}")
    rec["flash_attention"] = rank.get("flash_attention")
    rec["flash_attention_grad"] = rank.get("flash_attention_grad")
    if rec["flash_attention"] is None \
            or rec["flash_attention_grad"] is None:
        fails.append("the measured table lacks flash_attention or its "
                     "grad")
    rec["memory_profile_peak_bytes"] = prof["peak_bytes"]
    if cuda:
        rec["static_over_measured_peak"] = \
            prof["peak_bytes"] / rec["eager_step_peak_bytes"]
    del sA, sW, sB
    rec["ok"] = not fails
    card_line({"phase": "observability_bert_gauges", **rec})
    if fails:
        raise AssertionError(f"observability_bert_gauges: {fails}")
    return rec


RES_DIR = os.path.join(ROOT, "build", "chip_smoke_resilience")


def _save_gpt_params(np, cfg, params, dirname):
    """``params`` (``{JAX scope name: tensor}``) written by the port's
    ``io.save_params`` over ``gpt_logits``' program (a manifest with a
    sha256 a file)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as fio
    from paddle_tpu_torch.models import gpt
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        gpt.gpt_logits(cfg)
    scope = fluid.Scope()
    for n, t in params.items():
        scope.set(n, t)
    fio.save_params(fluid.Executor(fluid.CPUPlace()), dirname,
                    main_program=main, scope=scope)


def _wire_generate(np, endpoint, prompts, new, rid_prefix=None,
                   timeout=600):
    """``prompts`` on one thread and client each, started together:
    ``(threads, {i: tokens or exception})`` (join the threads)."""
    from paddle_tpu_torch.serving import Client
    out = {}

    def one(i):
        try:
            with Client(endpoint, timeout=timeout) as c:
                out[i] = c.generate(prompts[i], new, rid=None
                                    if rid_prefix is None
                                    else f"{rid_prefix}-{i}")
        except Exception as e:  # noqa: BLE001 — judged by the caller
            out[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads, out


def _join(threads, timeout=600):
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError("wire clients did not finish")


def _until(cond, timeout=120.0, interval=0.001):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def resilience_serving(torch, np, cfg, pa, device=None, max_len=2048, lo=64,
                       hi=1024, new=128, long_new=1024, watchdog_s=3.0):
    """GPT-base generation served over the wire under the resilience
    layer (paged fp32 pool, 8 decode slots, the LoopSupervisor on), with
    two seeded parameter sets A and B (B written by ``io.save_params``):

    1. reload mid-traffic: the serving path's 8 greedy prompts
       (``pr1_prompts``: ``lo``..``hi`` tokens, ``new`` new) twice on A
       (a warm pass, then tokens/s before); then, while
       they decode on A again, a ninth client's ``reload_weights(B)``
       (once all 8 rows decode, their next step is held by a callback
       on the ``serving.decode_step`` fault point until the swap is
       parked, so the reload lands mid-flight whatever its load takes);
       8 requests sent while the swap is pending queue; then the same
       8 prompts on B (tokens/s after) and 8 other prompts. The rows in
       flight give
       ``generate``'s tokens under A, the queued and later ones its
       tokens under B, and K5 launched 12 times per decode step over
       the whole window (the replayed graph produced them);
    2. a copy of B with one byte flipped: ``CheckpointCorruptError``
       over the wire, and the next request still B's tokens;
    3. one generate with one request id on two raw connections: it runs
       once, both get its tokens;
    4. a ``long_new``-token request cancelled by ``Client.cancel(rid)``
       while it decodes: ``RequestCancelledError``, its blocks back;
    5. ``chaos({"serving.decode_step": {"times": 1}})`` with 8 rows in
       flight: they fail typed, the decode loop restarts once, the state
       returns to serving, the next 8 requests give B's tokens, no block
       leaks;
    6. a decode-step stall of twice the watchdog (set to ``watchdog_s``
       for this check only): the 8 rows fail with WatchdogTimeout (an
       InternalServerError over the wire), the bank is rebuilt, the next
       8 requests give B's tokens;
    7. drain() with 8 requests in flight: new generates get
       ServerShutdownError, ping and health answer, the 8 finish with
       B's tokens, ``{"drained": true, "remaining": 0}``."""
    import shutil
    import tempfile

    from paddle_tpu_torch import resilience as res
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import (Client, InferenceServer,
                                          InternalServerError,
                                          RequestCancelledError,
                                          ServerShutdownError)
    from paddle_tpu_torch.serving.engine import copy_in_place
    params_a, params_b = init_params(cfg, seed=0), init_params(cfg, seed=1)
    prompts = pr1_prompts(np, cfg, lo, hi)
    later = pr1_prompts(np, cfg, lo, hi, seed=1)
    rec = {"phase": "resilience_serving", "slots": 8, "max_len": max_len,
           "kv": "paged fp32", "new_tokens": new, "prompts": [
               int(p.size) for p in prompts]}
    fails = []
    os.makedirs(RES_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=RES_DIR)
    dir_b, dir_bad = os.path.join(tmp, "B"), os.path.join(tmp, "B_bad")
    t0 = time.perf_counter()
    _save_gpt_params(np, cfg, params_b, dir_b)
    rec["save_b_s"] = time.perf_counter() - t0
    shutil.copytree(dir_b, dir_bad)
    flip_last_byte(os.path.join(dir_bad, "word_embedding.npy"))
    # references: offline greedy generate under A and under B
    refs = {}
    for name, params in (("A", params_a), ("B", params_b)):
        g = GPTGenerator(cfg, params, max_len=max_len, device=device)
        refs[name] = [np.asarray(t) for group in (prompts, later)
                      for t in g.generate(group, max_new_tokens=new,
                                          paged=True)]
        g.release()
        del g
    differ = sum(not np.array_equal(a, b)
                 for a, b in zip(refs["A"], refs["B"]))
    rec["refs_a_b_differ"] = differ
    if differ < len(refs["A"]) // 2:
        fails.append(f"A and B give the same greedy tokens on "
                     f"{len(refs['A']) - differ} prompts: the reload "
                     f"check could not tell them apart")
    ref_a, ref_b = refs["A"][:8], refs["B"][8:]
    ref_b_first = refs["B"][:8]
    gen = GPTGenerator(cfg, params_a, max_len=max_len, device=device)
    server = InferenceServer(generator=gen, decode_slots=8, paged=True)
    db, eng = server.decode_batcher, server.gen_engine
    pool = eng.pool
    k5 = pa.paged_attention
    ep = None

    def steps():
        return server.stats_sink.counter("decode_steps")

    def equal(out, refs_, what):
        bad = [i for i in range(len(refs_))
               if not isinstance(out.get(i), np.ndarray)
               or not np.array_equal(out[i], refs_[i])]
        if bad:
            fails.append(f"{what}: requests {bad} differ "
                         f"({[repr(out.get(i))[:120] for i in bad[:2]]})")
        return not bad

    try:
        server.start()
        ep = server.endpoint
        # warm: capture the decode graph, run the prompts' prefill shapes
        th, out = _wire_generate(np, ep, prompts, new)
        _join(th)
        equal(out, ref_a, "the warm-up requests, under A")
        # -- 1: reload mid-traffic (tokens/s before and after it timed
        # alike: the same 8 prompts, each pass after a warm one)
        k5_0, st_0 = k5.launches, steps()
        t_a = time.perf_counter()
        th, out_pre = _wire_generate(np, ep, prompts, new)
        _join(th)
        wall_pre = time.perf_counter() - t_a
        equal(out_pre, ref_a, "the requests before the reload, under A")
        box = {}

        def reload():
            with Client(ep, timeout=600) as c:
                t = time.perf_counter()
                box["report"] = c.reload_weights(dir_b, timeout=600)
                box["wall_s"] = time.perf_counter() - t

        def hold(point, ctx):
            # once all 8 rows decode, hold their step until the swap is
            # parked behind them
            if len(db._active) == 8:
                _until(lambda: db._swap is not None or "report" in box,
                       timeout=300, interval=0.002)

        th_r = threading.Thread(target=reload)
        with res.fault_injection("serving.decode_step", exc=hold, times=-1):
            th_a, out_a = _wire_generate(np, ep, prompts, new)
            if not _until(lambda: len(db._active) == 8):
                fails.append("the 8 requests never decoded together")
            th_r.start()
            if not _until(lambda: db._swap is not None or "report" in box,
                          timeout=300):
                fails.append("the swap was never parked")
        th_q, out_q = _wire_generate(np, ep, prompts, new)
        queued = _until(lambda: len(server.gen_queue) == 8
                        and db._swap is not None, timeout=60)
        _join(th_a)
        th_r.join(600)
        _join(th_q)
        t_b = time.perf_counter()
        th, out_same = _wire_generate(np, ep, prompts, new)
        _join(th)
        wall_post = time.perf_counter() - t_b
        th, out_post = _wire_generate(np, ep, later, new)
        _join(th)
        k5_1, st_1 = k5.launches, steps()
        rep = box.get("report", {})
        rec["reload"] = {
            "weights_version": rep.get("weights_version"),
            "swap_pause_ms": rep.get("swap_pause_ms"),
            "reload_wall_s": box.get("wall_s"),
            "queued_while_pending": queued,
            "tokens_per_s_before": 8 * new / wall_pre,
            "tokens_per_s_after": 8 * new / wall_post,
            "decode_steps": st_1 - st_0, "k5_launches": k5_1 - k5_0}
        if rep.get("weights_version") != 2:
            fails.append(f"reload reply {rep}")
        if not queued:
            fails.append("the 8 requests sent while the swap was pending "
                         "were not queued behind it")
        equal(out_a, ref_a, "requests in flight across the reload, "
                            "under A")
        equal(out_q, ref_b_first, "requests queued behind the swap, "
                                  "under B")
        equal(out_same, ref_b_first, "the timed requests after the "
                                     "reload, under B")
        equal(out_post, ref_b, "requests after the reload, under B")
        if gen.device.type == "cuda" \
                and k5_1 - k5_0 != cfg.num_layers * (st_1 - st_0):
            fails.append(f"K5 launched {k5_1 - k5_0} times in "
                         f"{st_1 - st_0} decode steps across the reload")
        # the in-place copy of the weights, timed alone (B onto B)
        live = gen.param_tensors()
        staged = {n: t.clone() for n, t in live.items()}
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        copy_in_place(live, staged)
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        rec["reload"]["copy_ms"] = (time.perf_counter() - t) * 1e3
        rec["reload"]["weight_gb"] = sum(
            x.numel() * x.element_size() for x in live.values()) / 1e9
        del staged
        # -- 2: a corrupt reload
        try:
            with Client(ep, timeout=600) as c:
                c.reload_weights(dir_bad)
            fails.append("the corrupt reload was accepted")
        except res.CheckpointCorruptError as e:
            rec["corrupt"] = {"refused": type(e).__name__,
                              "internal": isinstance(e, InternalServerError),
                              "message": str(e)[:160]}
        th, out = _wire_generate(np, ep, later[:1], new)
        _join(th)
        equal(out, ref_b[:1], "the request after the corrupt reload")
        # -- 3: one request id on two connections
        done0 = server.stats_sink.counter("requests_completed")
        msg = {"op": "generate", "tokens": later[1], "max_new_tokens": new,
               "temperature": 0.0, "top_k": 0, "eos_id": None,
               "deadline_ms": None, "rid": "chip-twin"}
        host, port = ep.rsplit(":", 1)
        import socket
        socks = [socket.create_connection((host, int(port)), timeout=600)
                 for _ in range(2)]
        try:
            for s in socks:
                wire.send_frame(s, msg, None)
            replies = [wire.recv_frame(s, None, timeout=600) for s in socks]
        finally:
            for s in socks:
                s.close()
        ran = server.stats_sink.counter("requests_completed") - done0
        rec["dedup"] = {"completed": ran, "dedup_hits":
                        server.stats_sink.counter("hedge_dedup_hits")}
        if ran != 1 or not all(r.get("ok") and np.array_equal(
                r["tokens"], ref_b[1]) for r in replies):
            fails.append(f"dedup: ran {ran} times, replies "
                         f"{[str(r)[:80] for r in replies]}")
        # -- 4: cancel a long request while it decodes
        blocks0 = pool.blocks_in_use()
        th, out = _wire_generate(np, ep, [later[0][:lo]], long_new,
                                 rid_prefix="chip-cancel")
        if not _until(lambda: len(db._active) == 1 and steps() > 0):
            fails.append("the long request never decoded")
        with Client(ep, timeout=600) as c:
            cancelled = c.cancel("chip-cancel-0")
        _join(th)
        st_c = steps()
        back = _until(lambda: pool.blocks_in_use() == blocks0, timeout=30)
        rec["cancel"] = {"cancelled": cancelled,
                         "error": type(out.get(0)).__name__,
                         "blocks_before": blocks0,
                         "blocks_after": pool.blocks_in_use(),
                         "steps_to_release": steps() - st_c}
        if not (cancelled and isinstance(out.get(0), RequestCancelledError)
                and back):
            fails.append(f"cancel: {rec['cancel']}")
        # -- 5: a crashed decode step restarts the loop
        restarts0 = server.health()["loops"]["decode"]["restarts"]
        th, out = _wire_generate(np, ep, later, new)
        if not _until(lambda: len(db._active) == 8):
            fails.append("crash: the 8 requests never decoded together")
        with res.chaos({"serving.decode_step": {"times": 1}}) as monkey:
            _join(th)
        typed = [type(v).__name__ for v in out.values()]
        ok = _until(lambda: server.health()["loops"]["decode"]["restarts"]
                    == restarts0 + 1 and server.state == "serving",
                    timeout=60)
        h = server.health()
        th, out2 = _wire_generate(np, ep, later, new)
        _join(th)
        leaks = eng.reclaim_leaks(list(db._active))
        rec["crash"] = {"fired": monkey.total_fired(), "errors": typed,
                        "restarts": h["loops"]["decode"]["restarts"]
                        - restarts0, "state": h["state"],
                        "leaked_blocks": leaks,
                        "blocks_in_use_idle": pool.blocks_in_use()}
        if not ok or monkey.total_fired() != 1 or leaks \
                or not all(isinstance(v, InternalServerError)
                           for v in out.values()):
            fails.append(f"crash and restart: {rec['crash']}")
        equal(out2, ref_b, "the requests after the restart")
        # -- 6: a stalled decode step trips the watchdog
        db.watchdog_s = float(watchdog_s)
        arrays0, decoder0 = pool.tensors()[0], eng.decoder
        th, out = _wire_generate(np, ep, later, new)
        if not _until(lambda: len(db._active) == 8):
            fails.append("watchdog: the 8 requests never decoded together")
        t_w = time.perf_counter()
        with res.chaos({"serving.decode_step": {"delay": 2 * watchdog_s,
                                                "times": 1}}):
            _join(th)
        trip_s = time.perf_counter() - t_w
        db.watchdog_s = float(server.config.loop_watchdog_s)
        errs = [type(v).__name__ for v in out.values()]
        rebuilt = eng.decoder is not decoder0
        th, out2 = _wire_generate(np, ep, later, new)
        _join(th)
        rec["watchdog"] = {"watchdog_s": watchdog_s,
                           "delay_s": 2 * watchdog_s, "errors": errs,
                           "all_internal": all(
                               isinstance(v, InternalServerError)
                               for v in out.values()),
                           "s_to_fail": trip_s, "bank_rebuilt": rebuilt,
                           "pool_arrays_new": pool.tensors()[0]
                           is not arrays0,
                           "watchdog_timeouts": server.stats_sink.counter(
                               "watchdog_timeouts")}
        if not (rebuilt and all(isinstance(v, res.WatchdogTimeout)
                                and isinstance(v, InternalServerError)
                                for v in out.values())):
            fails.append(f"watchdog: {rec['watchdog']}")
        equal(out2, ref_b, "the requests after the watchdog trip")
        # -- 7: drain with 8 requests in flight
        th, out = _wire_generate(np, ep, later, new)
        if not _until(lambda: len(db._active) == 8):
            fails.append("drain: the 8 requests never decoded together")
        dbox = {}
        th_d = threading.Thread(target=lambda: dbox.setdefault(
            "report", server.drain(timeout=600)))
        th_d.start()
        _until(lambda: server.state == "draining")
        probe = {}
        with Client(ep, timeout=600) as c:
            try:
                c.generate(later[0], 4)
                probe["generate"] = "served"
            except ServerShutdownError:
                probe["generate"] = "ServerShutdownError"
            probe["ping"] = c.ping()
            probe["health_state"] = c.health()["state"]
        th_d.join(600)
        _join(th)
        rec["drain"] = {"report": dbox.get("report"), **probe}
        if dbox.get("report") != {"drained": True, "remaining": 0} \
                or probe != {"generate": "ServerShutdownError",
                             "ping": True, "health_state": "draining"}:
            fails.append(f"drain: {rec['drain']}")
        equal(out, ref_b, "the requests drained")
        rec["health_last"] = h
        rec["stats"] = {k: server.stats_sink.counter(k) for k in (
            "requests_completed", "requests_failed", "requests_cancelled",
            "loop_restarts", "weight_reloads", "watchdog_timeouts",
            "hedge_dedup_hits", "engine_failures", "decode_steps")}
    finally:
        server.stop()
        gen.release()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["ok"] = not fails
    card_line(rec)
    if fails:
        raise AssertionError(f"resilience_serving: {fails}")
    return rec


SUP_DIR = os.path.join(ROOT, "build", "chip_smoke_supervised")


def _bert_slabs(np, cfg, B, S, P, K, n, seed):
    from paddle_tpu_torch.models import bert
    return [_stack(np, [bert.random_batch(
        cfg, B, S, P, rng=np.random.default_rng(seed + i * K + k))
        for k in range(K)]) for i in range(n)]


class _Timed:
    """Wraps a bound method, keeping each call's seconds in ``seconds``."""

    def __init__(self, fn, sync):
        self.fn, self.sync, self.seconds = fn, sync, []

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.sync()
            self.seconds.append(time.perf_counter() - t)


def supervised_bert(torch, np, fa, place=None, layers=None, B=16, S=2048,
                    P=64, K=2, n_slabs=6, watchdog_s=5.0, seed=19):
    """BERT-base at bench_bert_long's shape (B16 S2048 P64, flash
    attention, bf16 AMP, Adam at noam_decay, dropout 0.1) trained by
    ``train.TrainingSupervisor`` (``steps_per_run`` K over ``n_slabs``
    prestacked seeded slabs), four times from one startup, on one
    executor:

    1. clean: no periodic checkpoint, ``health_every_n=3`` (the
       reference);
    2. crash and hang: a checkpoint every 2 slabs, ``step_watchdog_s``
       ``watchdog_s``, and the ``train.dispatch`` fault point scripted to
       raise at slab 3's dispatch and to stall for twice the watchdog at
       slab 5's (after the restart from slab 2's checkpoint);
    3. preempt: ``request_preemption`` from ``on_slab_end`` at slab 2:
       ``PreemptedError`` naming the fast checkpoint;
    4. resume: a new supervisor on run 3's directory finishes it.

    Gates: runs 2 and 4 end with every scope tensor bitwise run 1's and
    report run 1's losses on every slab both report; run 2's restart
    errors are FaultInjected then WatchdogTimeout; the executor's
    captured entries do not grow after run 1 (a restart binds the fresh
    scope into the captured step); K1 and K2 launch 12 times per step
    executed, bf16, and no other kernel of the port; run 1's health
    gauges are finite; each run's goodput ledger spans the measured run
    within 1% and attributes no more than it."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience as res
    from paddle_tpu_torch import train
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    main, startup, out, lr, _ = build_bert(cfg, B, S, P)
    main.random_seed = startup.random_seed = seed
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    slabs = _bert_slabs(np, cfg, B, S, P, K, n_slabs, seed)
    loss = out["loss"]
    k1, k2 = fa.flash_attention_fwd, fa.flash_attention_bwd_single
    others = [fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]
    rec = {"phase": "supervised_bert", "B": B, "S": S, "P": P, "K": K,
           "slabs": n_slabs, "layers": cfg.num_layers,
           "dropout": cfg.hidden_dropout, "watchdog_s": watchdog_s}
    fails = []
    shutil.rmtree(SUP_DIR, ignore_errors=True)
    base = _peak_base(torch, cuda)
    runs = {}

    def supervise(name, **kw):
        done = []

        def on_end(slab, step, fetches, user=kw.pop("on_slab_end", None)):
            done.append(slab)
            if user is not None:
                user(slab, step, fetches)

        sup = train.TrainingSupervisor(
            exe, main, os.path.join(SUP_DIR, name), startup_program=startup,
            scope=fluid.Scope(), steps_per_run=K, restart_backoff=0.05,
            on_slab_end=on_end, **kw)
        sup.checkpoint.save = _Timed(sup.checkpoint.save, sync)
        sup.checkpoint.restore_latest = _Timed(
            sup.checkpoint.restore_latest, sync)
        sup._run_slab = _Timed(sup._run_slab, sync)
        return sup, done

    def launched(fn):
        c0 = (k1.launches, k2.launches, k1.bf16_launches, k2.bf16_launches,
              [o.launches for o in others])
        t = time.perf_counter()
        try:
            r = fn()
        finally:
            sync()
        wall = time.perf_counter() - t
        c1 = (k1.launches, k2.launches, k1.bf16_launches, k2.bf16_launches,
              [o.launches for o in others])
        return r, wall, {"k1": c1[0] - c0[0], "k2": c1[1] - c0[1],
                         "k1_bf16": c1[2] - c0[2], "k2_bf16": c1[3] - c0[3],
                         "others": sum(c1[4]) - sum(c0[4])}

    def summary(name, sup, done, result, wall, counts, warm=(0, 0)):
        steps = len(done) * K
        gp = result["goodput"] if result else sup.goodput_report()
        slab_ms = [t * 1e3 for t in sup._run_slab.seconds]
        entry = {
            "slabs_done": len(done), "steps_run": steps, "wall_s": wall,
            "launches": counts, "warmup_launches_k1_k2": list(warm),
            "saves_s": sup.checkpoint.save.seconds,
            "restores_s": sup.checkpoint.restore_latest.seconds,
            "goodput": {k: gp[k] for k in (
                "wall_s", "attributed_s", "unattributed_s", "overcount_s",
                "goodput_ratio")},
            "categories_s": gp["categories"],
            "slab_ms": slab_ms,
            "median_slab_ms": float(np.median(slab_ms)) if slab_ms
            else None}
        if result:
            entry.update({k: result.get(k) for k in (
                "restarts", "restart_errors", "recoveries_ms",
                "checkpoints")})
        runs[name] = entry
        # the ledger files what it did not attribute under ``other``, so
        # its categories sum to its own wall by construction: hold its
        # books against this phase's clock instead (its wall within 1%
        # of the measured run, its attributed categories not past it)
        if abs(gp["wall_s"] - wall) > 0.01 * wall \
                or gp["attributed_s"] > 1.01 * wall:
            fails.append(f"{name}: goodput ledger wall {gp['wall_s']:.3f}s, "
                         f"attributed {gp['attributed_s']:.3f}s against "
                         f"the measured {wall:.3f}s")
        want = cfg.num_layers * steps       # one K1 and one K2 a layer
        if cuda and (counts["k1"] - warm[0] != want
                     or counts["k2"] - warm[1] != want
                     or counts["k1_bf16"] != counts["k1"]
                     or counts["k2_bf16"] != counts["k2"]
                     or counts["others"]):
            fails.append(f"{name}: launches {counts} (warm-up {warm}) for "
                         f"{steps} steps; want {want} each, all bf16, no "
                         f"other kernel")
        return entry

    try:
        # -- 1: clean, with health slabs (the reference)
        sup1, done1 = supervise("clean", checkpoint_every_n_slabs=10 ** 6,
                                health_every_n=3)
        r1, wall, counts = launched(lambda: sup1.run_slabs(
            slabs, fetch_list=[loss], collect_fetches=True))
        warm = tuple(sum(e.warmup_launches.get((k, "launches"), 0)
                         for e in exe._graphs.values()) for k in (k1, k2))
        entries = exe.cache_stats()["entries"]
        per_replay = [{"k1": e.replay_launches.get((k1, "launches")),
                       "k2": e.replay_launches.get((k2, "launches"))}
                      for e in exe._graphs.values()]
        summary("clean", sup1, done1, r1, wall, counts, warm)
        hr = sup1.health_report()
        runs["clean"]["health"] = hr["values"]
        runs["clean"]["captured_entries"] = entries
        runs["clean"]["launches_per_replay"] = per_replay
        if not all(v is not None and np.isfinite(v)
                   for v in hr["values"].values()):
            fails.append(f"health gauges {hr['values']}")
        if cuda and any(p != {"k1": cfg.num_layers, "k2": cfg.num_layers}
                        for p in per_replay):
            fails.append(f"launches per replay {per_replay}")
        # -- 2: a crash at slab 3, a hang at slab 5
        hits = [0]

        def script(point, ctx):
            hits[0] += 1
            if hits[0] == 4:             # slab 3, the first attempt
                return res.FaultInjected("fault injected at "
                                         "train.dispatch (slab 3)")
            if hits[0] == 8:             # slab 5, after the restart
                time.sleep(2 * watchdog_s)
            return None

        sup2, done2 = supervise("crash", checkpoint_every_n_slabs=2,
                                step_watchdog_s=watchdog_s)
        with res.fault_injection("train.dispatch", exc=script, times=-1):
            r2, wall, counts = launched(lambda: sup2.run_slabs(
                slabs, fetch_list=[loss], collect_fetches=True))
        summary("crash_and_hang", sup2, done2, r2, wall, counts)
        runs["crash_and_hang"]["dispatch_hits"] = hits[0]
        if r2["restart_errors"] != ["FaultInjected", "WatchdogTimeout"]:
            fails.append(f"restart errors {r2['restart_errors']}")
        # -- 3: preempted at slab 2
        def preempt(slab, step, fetches):
            if slab == 2:
                train.request_preemption("chip_smoke")

        sup3, done3 = supervise("preempt", checkpoint_every_n_slabs=2,
                                on_slab_end=preempt)
        box = {}

        def run3():
            try:
                sup3.run_slabs(slabs, fetch_list=[loss],
                               collect_fetches=True)
            except train.PreemptedError as e:
                box["error"] = e
            finally:
                train.clear_preemption()

        _, wall, counts = launched(run3)
        perr = box.get("error")
        summary("preempt", sup3, done3, None, wall, counts)
        runs["preempt"].update({
            "slab": getattr(perr, "slab", None),
            "checkpoint_no": getattr(perr, "checkpoint_no", None),
            "reason": getattr(perr, "reason", None),
            "preempt_s": runs["preempt"]["categories_s"]["preempt"],
            "preempt_deadline_s": sup3.preempt_deadline_s})
        if perr is None or perr.slab != 2 or perr.checkpoint_no is None \
                or perr.checkpoint_no != sup3.checkpoint.latest_no():
            fails.append(f"preemption: {runs['preempt']}")
        # -- 4: resumed from run 3's checkpoint
        sup4, done4 = supervise("preempt", checkpoint_every_n_slabs=2)
        r4, wall, counts = launched(lambda: sup4.run_slabs(
            slabs, fetch_list=[loss], collect_fetches=True))
        summary("resume", sup4, done4, r4, wall, counts)
        runs["resume"]["first_slab"] = min(r4["fetches"])
        if min(r4["fetches"]) != 2 or r4["restarts"]:
            fails.append(f"resume began at slab {min(r4['fetches'])} with "
                         f"{r4['restarts']} restarts")
        # -- the gates across runs
        ref = r1["fetches"]
        for name, sup, r in (("crash_and_hang", sup2, r2),
                             ("resume", sup4, r4)):
            diff = scope_diff(torch, sup1.scope, sup.scope)
            losses = [i for i in r["fetches"]
                      if not np.array_equal(r["fetches"][i][0],
                                            ref[i][0])]
            runs[name]["scope_diff"] = diff[:8]
            runs[name]["loss_diff_slabs"] = losses
            if diff or losses:
                fails.append(f"{name}: scope differs from the clean run "
                             f"on {diff[:8]}, losses on slabs {losses}")
        if exe.cache_stats()["entries"] != entries:
            fails.append(f"captured entries grew: {entries} -> "
                         f"{exe.cache_stats()['entries']}")
        rec["captured_entries_after"] = exe.cache_stats()["entries"]
        rec["losses"] = [float(ref[i][0].reshape(-1)[-1])
                         for i in sorted(ref)]
    finally:
        train.clear_preemption()
        rec["runs"] = runs
        rec["peak_mem_gb"] = _peak_from(torch, cuda, base)
        _release(torch, exe)
        shutil.rmtree(SUP_DIR, ignore_errors=True)
    rec["ok"] = not fails
    card_line(rec)
    if fails:
        raise AssertionError(f"supervised_bert: {fails}")
    return rec


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="TREE", help="another checkout "
                    "(e.g. a git archive of the parent commit): each K5 "
                    "phase and the K2 determinism phase then time that "
                    "tree's kernel, called through its own wrapper, beside "
                    "the port's, in the order parent, new, new, parent")
    ap.add_argument("--dp-worker", metavar="ARGS", help="run as one rank "
                    "of a data-parallel phase (the launcher starts these)")
    ap.add_argument("--dp-serve", metavar="DIR", help="run as the resident "
                    "one-card worker, serving the phase requests put in DIR")
    ap.add_argument("--only-tp", action="store_true", help="build, check "
                    "K1, K2 and K5 at the tp paths' head counts, run the "
                    "tensor-parallel paths at N = every card and stop (no "
                    "kernels line, no ok line)")
    ap.add_argument("--only-sp", action="store_true", help="build, check "
                    "K1, K3 and K4 at the sequence-parallel flash shapes, "
                    "run the sequence-parallel paths at N = every card and "
                    "stop (no kernels line, no ok line)")
    ap.add_argument("--only-pp", action="store_true", help="build, check "
                    "K1, K3 and K4 at the pipeline stage's shape, run the "
                    "pipeline-parallel paths at N = every card and stop (no "
                    "kernels line, no ok line)")
    ap.add_argument("--only-moe", action="store_true", help="build, check "
                    "K1, K3 and K4 at the Switch GPT's attention shapes, run "
                    "the expert-parallel paths at N = every card and stop "
                    "(no kernels line, no ok line)")
    ap.add_argument("--only-dcn", action="store_true", help="build, check "
                    "K1 and K2 at dcn_bert's attention, run the multi-slice "
                    "paths (dcn_bert, slice_drill) at N = every card and "
                    "stop (no kernels line, no ok line)")
    ap.add_argument("--only-dp", action="store_true", help="build, run the "
                    "data-parallel paths at N = every card (no N = 1 runs "
                    "for the scaling line) and stop: a measurement of them "
                    "alone, with no kernels line and no ok line")
    args = ap.parse_args()
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.dp_serve:
        return dp_serve(args.dp_serve)
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD["card"] = smi
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.cuda.set_device(0)

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import GPTConfig
    t0 = time.perf_counter()
    parent = parent_paged(os.path.abspath(args.parent)) if args.parent \
        else None
    parent_fa = parent_flash() if args.parent else None
    parent_built = []
    if parent is not None:
        # that tree's paged and backward kernels build beside the port's
        import threading
        th = threading.Thread(target=lambda: parent_built.append(
            parent._build.build_all(("paged_attention",
                                     "flash_attention_bwd"))))
        th.start()
    # a current library whose compiler report was not kept is rebuilt, so
    # the ptxas lines and the spill check below see every kernel
    built = _build.build_all(force=[n for n in _build.SOURCES
                                    if _build.build_log(n) is None])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f}s "
          f"into {_build.BUILD_DIR}", flush=True)
    failures = []
    for name in _build.SOURCES:
        # the compiler's report of the current build, rebuilt or not
        rep = ptxas_report(name, _build.build_log(name))
        emit(rep)
        spilled = [k["entry"] for k in rep["kernels"]
                   if k.get("spill_stores") or k.get("spill_loads")]
        if name == "paged_attention" and spilled:
            failures.append(f"K5 instantiations spill registers: {spilled}")
    for name in _build.SOURCES:
        rep = sass_report(_build._nvcc(), _build._paths(name)[1])
        if rep is not None:
            emit(rep)
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    if parent is not None:
        th.join()
        if not parent_built:
            raise RuntimeError(f"{args.parent}: its paged kernel did not "
                               f"build")

    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_single": fa.flash_attention_bwd_single,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "paged_attention": pa.paged_attention}
    launches = dict.fromkeys(counters, 0)

    def drive(path, needs, fn):
        """Run one main path with every launch count zeroed just before
        it and read just after; ``needs`` must each have launched."""
        for c in counters.values():
            c.launches = 0
            if hasattr(c, "bf16_launches"):
                c.bf16_launches = 0
        t_path = time.perf_counter()
        rec = fn()
        seconds = time.perf_counter() - t_path
        got = {n: c.launches for n, c in counters.items()}
        bf16 = {n: c.bf16_launches for n, c in counters.items()
                if hasattr(c, "bf16_launches")}
        gc.collect()       # a path's graphs that only cycles still hold
        torch.cuda.empty_cache()
        # what the path left on the card (a live graph keeps its pool)
        emit({"phase": f"launches_{path}", "launches": got,
              "bf16_launches": bf16, "seconds": seconds,
              "since_start_s": time.perf_counter() - t0,
              "allocated_gb_after": torch.cuda.memory_allocated() / 1e9,
              "reserved_gb_after": torch.cuda.memory_reserved() / 1e9})
        if needs and min(got[n] for n in needs) < 1:
            raise AssertionError(f"a kernel of the {path} path never "
                                 f"launched: {got}")
        for n, c in got.items():
            launches[n] += c
        return rec, got, bf16

    def drive_dp():
        """Data parallelism across cards, one rank a card through the
        port's launcher (every card of the machine; at N > 1 dp_resnet50
        and fleet_bert also at N = 1): the contract at small width,
        bench_resnet50 through CompiledProgram.with_data_parallel and
        BERT-base at bench_bert_long's shape through the Fleet collective
        (K1 and K2, 12 a step on every rank, bf16). The ranks' launches
        join the counts."""
        if torch.cuda.device_count() > 1:
            print(subprocess.run(["nvidia-smi", "topo", "-m"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout, flush=True)
        for name, needs in (("dp_parity", ()), ("dp_resnet50", ()),
                            ("fleet_bert", DP_BERT_KERNELS)):
            _, got, bf16 = drive(name, needs, lambda name=name: dp_phases(
                torch, np, counters, name, at_one=not args.only_dp))
            others = {k: c for k, c in got.items() if c and k not in needs}
            if others or any(bf16[k] != got[k] for k in needs):
                failures.append(f"the {name} path launched {got} (bf16 "
                                f"{bf16}): only {needs}, all bf16, may "
                                f"launch")

    def drive_tp():
        """Tensor parallelism across cards, one rank a card through the
        port's launcher at N = every card (dp 2 x tp 2 and tp 4 on four
        cards, tp 2 on two, tp 1 through the same code on one): K1, K2
        and K5 against their plain versions at the paths' head counts
        first (not counted), then tp_parity (K1, K2 float32), tp_bert (K1
        and K2, 12 a step each, all bf16), tp_generate (K1, K5) and
        tp_serving (K1, K5; its line carries tp_generate's rows of this
        run). The ranks' launches join the counts."""
        tp_kernel_shapes(torch, fa, pa)
        recs = {}
        for name, needs in (("tp_parity", DP_BERT_KERNELS),
                            ("tp_bert", DP_BERT_KERNELS),
                            ("tp_generate", ("flash_attention_fwd",
                                             "paged_attention")),
                            ("tp_serving", ("flash_attention_fwd",
                                            "paged_attention"))):
            beside = {}
            if name == "tp_serving":
                gr = recs["tp_generate"]
                beside = {k: {m: gr[k][m] for m in (
                    "tokens_per_sec", "decode_ms_per_step",
                    "weight_bytes_a_card")} for k in gr
                    if k.startswith("tp") and isinstance(gr[k], dict)}
            recs[name], got, bf16 = drive(
                name, needs, lambda name=name, beside=beside: tp_phases(
                    torch, np, counters, name,
                    args={"beside": beside} if beside else None))
            others = {k: c for k, c in got.items() if c and k not in needs}
            if others or (name == "tp_bert" and any(
                    bf16[k] != got[k] for k in needs)):
                failures.append(f"the {name} path launched {got} (bf16 "
                                f"{bf16}): only {needs} may launch"
                                + (", all bf16" if name == "tp_bert"
                                   else ""))

    def drive_sp():
        """Sequence parallelism across cards, one rank a card through the
        port's launcher at N = every card (sp 4, and tp 2 x sp 2 in
        sp_parity, on four cards; sp 1 through the same code on one): K1,
        K3 and K4 against their plain versions at sp_bert's flash shape
        first (not counted), then sp_parity (K1, K2 float32 under flash;
        no kernel of the port under einsum, ring or Ulysses) and sp_bert
        (BERT-base at S 2048 a card: K1 and K3 + K4, 12 a step each
        under flash, K2 in their place at one card's S 2048; nothing
        under ring and Ulysses). The ranks' launches join the counts."""
        from paddle_tpu_torch.kernels.flash_attention import \
            single_pass_backward
        sp_kernel_shapes(torch, fa)
        n = torch.cuda.device_count()
        long = ("flash_attention_bwd_single",) if single_pass_backward(
            SP_BERT["S_per_card"] * n, False) else (
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
        for name, needs in (("sp_parity", DP_BERT_KERNELS),
                            ("sp_bert", ("flash_attention_fwd",) + long)):
            _, got, _ = drive(name, needs, lambda name=name: sp_phases(
                torch, np, counters, name))
            # sp_bert's one-card reference runs the same kernels
            others = {k: c for k, c in got.items() if c and k not in needs}
            if others:
                failures.append(f"the {name} path launched {got}: only "
                                f"{needs} may launch")

    def drive_pp():
        """Pipeline parallelism across cards, one rank a card through the
        port's launcher at N = every card (pp 4 and pp 2 x dp 2 on four
        cards, pp 2 on two, a 2-stage pipeline on the sequential path on
        one): K1, K3 and K4 against their plain versions at the stage's
        shape first (not counted), then pp_parity (the narrow GPT: K1 and
        K2, float32) and pp_gpt (GPT-base at B8 S2048: K1 and K3 + K4 at
        the schedule's count a step on every rank, rank 0's one-card
        runs included). The ranks' launches join the counts."""
        pp_kernel_shapes(torch, fa)
        for name, needs in (("pp_parity", DP_BERT_KERNELS),
                            ("pp_gpt", ("flash_attention_fwd",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv"))):
            _, got, _ = drive(name, needs, lambda name=name: pp_phases(
                torch, np, counters, name))
            others = {k: c for k, c in got.items() if c and k not in needs}
            if others:
                failures.append(f"the {name} path launched {got}: only "
                                f"{needs} may launch")

    def drive_moe():
        """Expert parallelism across cards, one rank a card through the
        port's launcher at N = every card (ep 4, ep 2 x dp 2 and ep 2 x
        tp 2 on four cards, and in moe_parity ep 2 x sp 2 and pp 2 x ep
        2; ep 2 on two, ep 1 through the same code on one): K1, K3
        and K4 against their plain versions at the Switch GPT's attention
        shapes first (not counted), then moe_parity (the narrow Switch
        GPT: K1 and K2, float32) and moe_gpt (the Switch GPT-base at B8
        S2048: K1, K3 and K4 12 a step on every rank, rank 0's one-card
        run included). The ranks' launches join the counts."""
        moe_kernel_shapes(torch, fa)
        for name, needs in (("moe_parity", DP_BERT_KERNELS),
                            ("moe_gpt", ("flash_attention_fwd",
                                         "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv"))):
            _, got, _ = drive(name, needs, lambda name=name: moe_phases(
                torch, np, counters, name))
            others = {k: c for k, c in got.items() if c and k not in needs}
            if others:
                failures.append(f"the {name} path launched {got}: only "
                                f"{needs} may launch")

    def drive_dcn():
        """Multi-slice data parallelism across cards, one rank a card
        through the port's launcher at N = every card (two slices of two
        on four cards; dcn_dp 1 through the same code elsewhere): K1 and
        K2 against their plain versions at dcn_bert's attention first
        (not counted), then dcn_bert (BERT-base at a global B16 S2048:
        the decomposed sync, the flat one and dp 4; K1 and K2 12 a step
        on every rank, all bf16) and slice_drill (a narrow BERT under
        train.SliceSupervisor: a slice lost and regrown; K1 and K2). The
        ranks' launches join the counts."""
        dcn_kernel_shapes(torch, fa)
        for name in ("dcn_bert", "slice_drill"):
            _, got, bf16 = drive(name, DP_BERT_KERNELS,
                                 lambda name=name: dcn_phases(
                                     torch, np, counters, name))
            others = {k: c for k, c in got.items()
                      if c and k not in DP_BERT_KERNELS}
            if others or (name == "dcn_bert" and any(
                    bf16[k] != got[k] for k in DP_BERT_KERNELS)):
                failures.append(f"the {name} path launched {got} (bf16 "
                                f"{bf16}): only {DP_BERT_KERNELS} may "
                                f"launch" + (", all bf16" if name ==
                                             "dcn_bert" else ""))

    # on one card each family's phases share one worker process
    one_card = torch.cuda.device_count() == 1
    only = [w for w in ("dp", "tp", "sp", "pp", "moe", "dcn")
            if getattr(args, f"only_{w}")]
    if only:
        which = only[0]
        with resident(torch, one_card):
            {"dp": drive_dp, "tp": drive_tp, "sp": drive_sp,
             "pp": drive_pp, "moe": drive_moe, "dcn": drive_dcn}[which]()
        if failures:
            print(f"failed: {failures}", file=sys.stderr)
            return 1
        kind = {"dp": "data", "tp": "tensor", "sp": "sequence",
                "pp": "pipeline", "moe": "expert",
                "dcn": "multi-slice data"}[which]
        print(f"--only-{which}: the {kind}-parallel paths passed; no other "
              f"phase ran", flush=True)
        return 0

    # causal phases take q/k/v as the prefill lays them out (strided views
    # of one qkv projection); one contiguous causal run and the
    # non-causal bias run cover the other layout
    main_fa = None
    for S in (128, 1024, 2048):
        for dtype in ("float32", "bfloat16"):
            rec = flash_phase(torch, fa, 8, 12, S, 64, dtype, True, False,
                              seed=S, packed=True)
            if S == 1024 and dtype == "float32":
                main_fa = rec
    flash_phase(torch, fa, 8, 12, 1024, 64, "float32", True, False, seed=2,
                packed=False)
    flash_phase(torch, fa, 8, 12, 1024, 64, "float32", False, True, seed=1,
                packed=False)
    # the tiling's edges: head dim 128 (H6 keeps the width at 768) and a
    # ragged S = 1000, both types, causal; non-causal + bias at D = 128
    edges = ((6, 1024, 128), (12, 1000, 64), (6, 1000, 128))
    for H, S, D in edges:
        for dtype in ("float32", "bfloat16"):
            flash_phase(torch, fa, 8, H, S, D, dtype, True, False,
                        seed=S + D, packed=True)
    flash_phase(torch, fa, 8, 6, 1024, 128, "float32", False, True, seed=3,
                packed=False)
    # head dims 80 and 96 (D128's tile plan)
    for D in (80, 96):
        for dtype in ("float32", "bfloat16"):
            flash_phase(torch, fa, 4, 8, 1024, D, dtype, True, False,
                        seed=D, packed=True)
    main_pa = paged_phases(torch, pa, parent)
    # the S > 1 paged read (speculative verify, chunked prefill) at the
    # served verify shape (spec_k 4), beside K5
    gather_route(torch, np, pa, S=5)

    # K2 at the S1024 shape, K3/K4 at S2048, causal on the model's
    # strided views; then non-causal + bias and bf16
    main_bwd = {}
    for name, S in (("flash_attention_bwd_single", 1024),
                    ("flash_attention_bwd_dq", 2048),
                    ("flash_attention_bwd_dkv", 2048)):
        main_bwd[name] = bwd_phase(torch, fa, name, 8, 12, S, 64, "float32",
                                   True, False, seed=S + 5, packed=True)
        bwd_phase(torch, fa, name, 8, 12, S, 64, "float32", False, True,
                  seed=S + 6, packed=False)
        bwd_phase(torch, fa, name, 8, 12, S, 64, "bfloat16", True, False,
                  seed=S + 7, packed=True)
    for H, S, D in edges:
        for dtype in ("float32", "bfloat16"):
            bwd_phase(torch, fa, "flash_attention_bwd_single", 8, H, S, D,
                      dtype, True, False, seed=S + D + 1, packed=True)
    # K3/K4 at their tiling's edges: head dim 128 (H6) and a ragged S =
    # 2000, both types, causal; non-causal + bias at D = 128
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        for H, S, D in ((6, 2048, 128), (12, 2000, 64), (6, 2000, 128)):
            for dtype in ("float32", "bfloat16"):
                bwd_phase(torch, fa, name, 8, H, S, D, dtype, True, False,
                          seed=S + D + 2, packed=True)
        bwd_phase(torch, fa, name, 8, 6, 2048, 128, "float32", False, True,
                  seed=4, packed=False)
    # head dims 80 and 96 (D128's tile plan): K2 at S1024, K3/K4 at
    # causal S2048 (D80)
    for dtype in ("float32", "bfloat16"):
        for D in (80, 96):
            bwd_phase(torch, fa, "flash_attention_bwd_single", 4, 8, 1024,
                      D, dtype, True, False, seed=D + 1, packed=True)
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            bwd_phase(torch, fa, name, 4, 8, 2048, 80, dtype, True, False,
                      seed=83, packed=True)
    # K2 off its route, at the S2048 shape of K3 + K4, for the route rule
    bwd_phase(torch, fa, "flash_attention_bwd_single", 8, 12, 2048, 64,
              "float32", True, False, seed=2053, packed=True)
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        k2_determinism(torch, fa, dtype, parent_fa)
    torch.cuda.empty_cache()
    # the route rule: K3 + K4 (the route of causal S2048 and S4096)
    # against K2 off its route and SDPA's backward
    for S in (2048, 4096):
        for dtype in ("float32", "bfloat16"):
            bwd_pair_phase(torch, fa, 8, 12, S, 64, dtype, seed=S + 8)
            torch.cuda.empty_cache()
    # K1 and K2 at bench_bert_long's attention (B16 H12 S2048 D64,
    # non-causal, a key bias masking each row's padded tail), then K3 +
    # K4 off their route there against K2 and SDPA's backward
    bert_k = {}
    for dtype in ("float32", "bfloat16"):
        bert_k[("fwd", dtype)] = flash_phase(
            torch, fa, 16, 12, 2048, 64, dtype, False, "padded", seed=2049,
            packed=True)
        bert_k[("bwd", dtype)] = bwd_phase(
            torch, fa, "flash_attention_bwd_single", 16, 12, 2048, 64,
            dtype, False, "padded", seed=2050, packed=True)
        torch.cuda.empty_cache()
        bwd_pair_phase(torch, fa, 16, 12, 2048, 64, dtype, seed=2051,
                       causal=False, with_bias="padded")
        torch.cuda.empty_cache()

    # on one card every family's phases share one worker process (a
    # worker's start, its import torch and CUDA context, cost ~10-15 s)
    with resident(torch, one_card):
        for family in (drive_dp, drive_tp, drive_sp, drive_pp, drive_moe,
                       drive_dcn):
            family()

    # the dygraph paths (they need two eager B256 Transformer steps of
    # memory, ~15 GB each): bench_dygraph_transformer by jit_step (one
    # CUDA graph over the taped step), the dygraph-vs-static BERT A/B and
    # the capture refusals; no kernel of the port (attention as matmul +
    # softmax, and einsum)
    for name, fn in (("dygraph_transformer",
                      lambda: dygraph_transformer(torch, np)),
                     ("dygraph_bert_ab", lambda: dygraph_bert_ab(
                         torch, np,
                         layers=ONE_CARD_LAYERS["dygraph_bert_ab"])),
                     ("dygraph_capture_refusals",
                      lambda: dygraph_capture_refusals(torch, np))):
        _, got, _ = drive(name, (), fn)
        if any(got.values()):
            failures.append(f"the {name} path launched a kernel of the "
                            f"port: {got}")

    # control flow and the sequence models: the GRU seq2seq at IWSLT'15
    # en-vi widths trained by run and run_steps, then beam-decoded eagerly,
    # by replay and from its saved model; the sub-block ops on small
    # programs (capture refusals included); the book's sequence models. No
    # kernel of the port (the JAX package lowers them all to XLA loops)
    s2s = {}

    def s2s_train():
        rec, s2s["scope"] = seq2seq_train(torch, np)
        return rec

    for name, fn in (("seq2seq_train", s2s_train),
                     ("seq2seq_decode",
                      lambda: seq2seq_decode(torch, np, s2s.pop("scope"))),
                     ("control_flow", lambda: control_flow(torch, np)),
                     ("sequence_lstm", lambda: sequence_lstm(torch, np))):
        _, got, _ = drive(name, (), fn)
        if any(got.values()):
            failures.append(f"the {name} path launched a kernel of the "
                            f"port: {got}")

    # the optimizer stack and exact resume: BERT-base at bench_bert_long's
    # shape under LAMB + global-norm clipping (K1, K2 in bf16), trained by
    # run_steps, checkpointed (sync and in the background) and resumed in
    # a fresh executor; ResNet-50 under Momentum + L2 decay and LARS; every
    # optimizer and wrapper on an MLP; the dygraph Transformer-base with a
    # clip and a decay under jit_step. Only bert_lamb may launch a kernel
    # of the port, and only K1 and K2
    lamb_needs = ("flash_attention_fwd", "flash_attention_bwd_single")
    for name, needs, fn in (
            ("bert_lamb", lamb_needs, lambda: bert_lamb(torch, np, fa)),
            ("resnet_l2", (), lambda: resnet_l2(torch, np)),
            ("optimizer_zoo", (), lambda: optimizer_zoo(torch, np)),
            ("dygraph_clip", (), lambda: dygraph_clip(torch, np))):
        _, got, bf16 = drive(name, needs, fn)
        others = {n: c for n, c in got.items() if c and n not in needs}
        if others or any(bf16[n] != got[n] for n in needs):
            failures.append(f"the {name} path launched {got} (bf16 "
                            f"{bf16}): only {needs}, all bf16, may launch")
        torch.cuda.empty_cache()

    cfg = GPTConfig.base()

    def serving():
        rec = end_to_end(torch, np, cfg)
        rec["k5_base"] = pa.paged_attention.launches
        tiny_generate(torch, np)
        rec["k5_tiny"] = pa.paged_attention.launches - rec["k5_base"]
        return rec

    rec, got, _ = drive("serving", ("flash_attention_fwd",
                                    "paged_attention"), serving)
    # one K5 wrapper call per layer of every paged decode step
    steps = rec["paged_decode_steps"]
    emit({"phase": "paged_launches_per_decode_step", "steps": steps,
          "launches": rec["k5_base"], "per_step": rec["k5_base"] / steps,
          "tiny_config_launches": rec["k5_tiny"]})
    if rec["k5_base"] != cfg.num_layers * steps:
        failures.append(f"K5 launched {rec['k5_base']} times in {steps} "
                        f"paged decode steps")
    if rec["k5_tiny"] < 1:
        failures.append("the tiny config's paged generate never launched "
                        "K5")
    # the rest of generation serving at GPT-base: the decode step as a
    # replayed graph against its eager twin, bench_decode (cached against
    # the full recompute, the paged rows), speculative decoding, the
    # prefix cache, chunked prefill, KV migration between two servers,
    # and all of them on at once behind the server
    gen_needs = ("flash_attention_fwd", "paged_attention")
    for name, needs, fn in (
            ("decode_capture", gen_needs,
             lambda: decode_capture(torch, np, cfg)),
            ("bench_decode", gen_needs,
             lambda: bench_decode_phase(torch, np, cfg)),
            ("spec_decode", gen_needs, lambda: spec_decode(torch, np, cfg)),
            ("prefix_prefill", (), lambda: prefix_prefill(torch, np, cfg)),
            ("chunked_prefill", gen_needs,
             lambda: chunked_prefill(torch, np, cfg)),
            ("kv_migration", gen_needs,
             lambda: kv_migration(torch, np, cfg)),
            ("server_full", ("paged_attention",),
             lambda: server_full(torch, np, cfg))):
        _, got, _ = drive(name, needs, fn)
        if name == "prefix_prefill" and got["paged_attention"]:
            failures.append(f"prefix_prefill launched K5 {got}: its chunk "
                            f"reads must take the gather route")
    long_needs = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    for S, amp, needs in (
            (2048, None, long_needs),
            (1024, None, ("flash_attention_fwd",
                          "flash_attention_bwd_single")),
            (2048, "static", long_needs)):
        rec, got, bf16 = drive(
            f"train_S{S}" + ("" if amp is None else "_amp_bf16"), needs,
            lambda S=S, amp=amp: train_phase(torch, np, GPTConfig.base(), 8,
                                             S, 5, amp=amp))
        rec["launches_per_step"] = {n: c / rec["steps"]
                                    for n, c in got.items()}
        rec["bf16_launches_per_step"] = {n: c / rec["steps"]
                                         for n, c in bf16.items()}
        emit(rec)
        if amp is not None and any(bf16[n] != got[n] for n in needs):
            failures.append(f"the AMP step launched {needs} with other "
                            f"than bf16 inputs: {got}, bf16 {bf16}")
    small = GPTConfig.base()
    small.num_layers = 2
    for S in (1024, 2048):
        for amp in (None, "static"):
            grad_check(torch, np, small, 8, S, amp=amp)
            torch.cuda.empty_cache()
    pipeline_ab(torch, np, small, 8, 1024)
    dynamic_scaling(torch, np, small, 8, 1024, 3)
    torch.cuda.empty_cache()

    # BERT-base pretraining, bench.py's two trainers: bert_long (K1, K2 in
    # bf16, once per layer and step each) and the flagship (einsum
    # attention: no kernel of the port)
    bert_needs = ("flash_attention_fwd", "flash_attention_bwd_single")
    for run, needs in ((BERT_LONG, bert_needs), (BERT_FLAGSHIP, ())):
        rec, got, bf16 = drive(
            f"train_{run['name']}_amp_bf16", needs,
            lambda run=run: bert_train_phase(torch, np, run, 5))
        rec["launches_per_step"] = {n: c / rec["steps"]
                                    for n, c in got.items()}
        rec["bf16_launches_per_step"] = {n: c / rec["steps"]
                                         for n, c in bf16.items()}
        emit(rec)
        want = {n: rec["layers"] * rec["steps"] if n in needs else 0
                for n in got}
        if got != want or any(bf16[n] != got[n] for n in needs):
            failures.append(f"{run['name']} launched {got} (bf16 {bf16}), "
                            f"not once per layer and step: {want}")
    drive("eval_bert_entry", (), lambda: eval_bert_entry(torch, np))
    drive("bert_verified_step", bert_needs,
          lambda: bert_verified_step(torch, np))
    bert_small(torch, np)
    torch.cuda.empty_cache()

    # ResNet-50 (bench.py's bench_resnet50) and LeNet (BASELINE config 1):
    # convolutions in cuDNN, GEMMs in cuBLAS, no kernel of the port
    trained = {}

    def resnet50():
        rec, trained["scope"], trained["exe"] = resnet_train_phase(torch, np)
        return rec

    rec, _, _ = drive("resnet50_train", (), resnet50)
    emit(rec)
    drive("resnet50_eval", (), lambda: resnet_eval_phase(
        torch, np, trained["scope"], trained["exe"]))
    trained.clear()
    # Queue 3's fault 3: FLAGS_cudnn_deterministic off and on at
    # bench_resnet50's step, and LeNet run to run
    drive("cudnn_deterministic_ab", (),
          lambda: cudnn_deterministic_ab(torch, np))
    drive("resnet18_tiny_trains", (), lambda: resnet18_tiny_trains(torch, np))
    resnet_grads(torch, np)
    for opt, lr in (("adam", 0.001), ("sgd", 0.01)):
        drive(f"lenet_train_{opt}", (),
              lambda opt=opt, lr=lr: lenet_train(torch, np, opt, lr))
    fused_optimizers(torch, np)
    torch.cuda.empty_cache()

    # saved-model persistence and serving: io at ResNet-50's width, then
    # ResNet-50 (cuDNN, no kernel of the port) and BERT-base with flash
    # attention (K1 once per layer of every executed batch) served from
    # their saved directories under bench_serving's traffic, each bucket
    # a captured CUDA graph
    drive("io_roundtrip", (), lambda: io_roundtrip(torch, np))
    served = {}
    for name, build, request, needs, k1 in (
            ("resnet50", resnet50_serving_program, image_request, (), 0),
            ("bert_base", bert_serving_program, bert_request,
             ("flash_attention_fwd",), 12)):
        _, got, _ = drive(f"serve_{name}", needs, lambda b=build, r=request,
                          n=name: served.setdefault(n, serve_traffic(
                              torch, np, n, b, r)))
        check_served(torch, np, served.pop(name), got, k1)
        torch.cuda.empty_cache()
    # K1 at the served shape: B32 H12 S128 D64 f32, non-causal, each
    # row's padded tail masked by the key bias
    flash_phase(torch, fa, 32, 12, 128, 64, "float32", False, "padded",
                seed=129, packed=True)
    capture_refuses_host_sync(torch, np)
    torch.cuda.empty_cache()

    # the training loop: run_steps (a captured step replayed), the
    # non-finite guard and rollback, train_from_dataset; the slice's path
    # first: BERT-base at bench_bert_long's shape under recompute, K1
    # forward and recomputed and K2 inside a captured training graph
    drive("bert_long_recompute", bert_needs,
          lambda: bert_long_recompute(torch, np, fa))
    drive("capture_names_flash_grad", bert_needs,
          lambda: capture_names_flash_grad(torch, np))
    drive("flagship_steps", (), lambda: flagship_steps(
        torch, np, layers=ONE_CARD_LAYERS["flagship_steps"]))
    drive("train_loop_lenet", (), lambda: train_loop_lenet(torch, np))
    drive("nonfinite_steps", bert_needs,
          lambda: nonfinite_steps(torch, np))
    drive("train_from_dataset", (),
          lambda: train_from_dataset_phase(torch, np))
    torch.cuda.empty_cache()

    # Wide&Deep CTR (bench.py's bench_widedeep) with SelectedRows
    # embedding grads: trained by run and run_steps, lazy Adam captured,
    # then the trained model served from its saved directory; no kernel
    # of the port (the JAX package's sparse updates are XLA scatters)
    wd = {}

    def wd_train():
        rec, wd["scope"] = widedeep_train(torch, np)
        return rec

    paths = [drive("widedeep_train", (), wd_train)[1],
             drive("widedeep_lazy_adam", (),
                   lambda: widedeep_lazy_adam(torch, np))[1]]
    _, got, _ = drive("widedeep_serve", (), lambda: served.setdefault(
        "widedeep", serve_traffic(
            torch, np, "widedeep", widedeep_serving_program,
            widedeep_request, traffic=dict(SERVE_TRAFFIC,
                                           request_batches=(1, 32)),
            scope=wd.pop("scope"))))
    check_served(torch, np, served.pop("widedeep"), got, 0)
    for got in paths + [got]:
        if any(got.values()):
            failures.append(f"a Wide&Deep path launched a kernel of the "
                            f"port: {got}")

    # the core layer surface: GPT's generation programs through the
    # Executor (K1 in the prefill, K5 in the paged decode steps), the
    # book's VGG16 at full width, and the seven book programs
    drive("gpt_programs", ("flash_attention_fwd", "paged_attention"),
          lambda: gpt_programs(torch, np, cfg))
    torch.cuda.empty_cache()
    for name, fn in (("book_vgg16", lambda: book_vgg16(torch, np)),
                     ("book_models", lambda: book_models(torch, np))):
        _, got, _ = drive(name, (), fn)
        if any(got.values()):
            failures.append(f"the {name} path launched a kernel of the "
                            f"port: {got}")

    # the observability core: GPT-base served and traced over the wire
    # (K1 prefills, K5 decode steps), its metrics scraped, the device
    # trace's kernel records held to the launch counters (bert_lamb's
    # Adam A/B read BERT-base's live gauges above)
    drive("observability", ("flash_attention_fwd", "paged_attention"),
          lambda: observability_phase(torch, np, cfg, fa, pa))

    # training and serving resilience: GPT-base served through a hot
    # reload, a corrupt reload, dedup, cancel, a crashed and a hung decode
    # loop and a drain (K1, K5); BERT-base trained under the
    # TrainingSupervisor through a crash, a hang, a preemption and a
    # resume, bitwise the clean run (K1, K2 only, bf16)
    drive("resilience_serving", ("flash_attention_fwd", "paged_attention"),
          lambda: resilience_serving(torch, np, cfg, pa))
    torch.cuda.empty_cache()
    _, got, bf16 = drive("supervised_bert", lamb_needs,
                         lambda: supervised_bert(
                             torch, np, fa,
                             layers=ONE_CARD_LAYERS["supervised_bert"]))
    others = {n: c for n, c in got.items() if c and n not in lamb_needs}
    if others or any(bf16[n] != got[n] for n in lamb_needs):
        failures.append(f"the supervised_bert path launched {got} (bf16 "
                        f"{bf16}): only {lamb_needs}, all bf16, may launch")

    kernels = []
    rows = [("flash_attention_fwd", FA_SOURCE, FA_REPLACES, main_fa),
            ("paged_attention", PA_SOURCE, PA_REPLACES, main_pa)]
    rows += [(n, BWD_SOURCE, BWD_KERNELS[n][0], main_bwd[n])
             for n in main_bwd]
    for name, source, replaces, rec in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    if failures:
        print(f"failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — report, then fail the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
