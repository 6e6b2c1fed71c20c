#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and ``nvcc`` (it
builds the kernels from ``vision_collision_detection_tpu_torch/ops/csrc``)
and imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. Build the kernels; print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   flagship shapes (K1 at N=200, 126×224 → 224, at the ViViT's 256 frames
   of 189×336 → 336 and at 120×213 → 224, bars on every side and content
   rows off the 16-byte boundary, each writing bf16 and float32, bit-equal;
   K2 and K3 at the four ConvNeXt stage shapes, K3 with tanh and erf
   GELU), random weights with layer-scale γ of order 1, TF32 off for the
   plain side. K3 is held on its largest and its mean error, and faulty
   plain versions (γ off by 1%, b2 dropped, the other GELU form) must land
   outside those tolerances. K3 in bf16 runs on its Hopper kernel
   (``convnext_mlp_wgmma.cu``), held again at every width it takes (96 to
   768), eval and train, both GELU forms, at 100 and 2,000 rows, with the
   same faults. K2 in bf16 runs on its Hopper kernel (``dwconv_hopper.cu``,
   a CUDA-core stencil), held at the four stage shapes, bit-equal over two
   runs, with the taps transposed (dy ↔ dx) in the plain version landing
   outside; ``dwconv.cu`` on the same inputs, the route forced; then the
   Hopper kernel's forward and dx at the last stage of 112² and 40² frames
   ([200, 4, 4, 768], [64, 2, 2, 768]), at odd sides ([64, 3, 5, 384],
   [64, 10, 6, 96]) and at [64, 16, 64, 96], a short frame too wide to be
   staged whole. K3 in bf16 at 1024 and 1536 runs on its split kernel
   (``convnext_mlp_wide.cu``: a LayerNorm and two wgmma GEMMs), held the
   same way at 100, 2,000 and 9,800 rows, two calls bit-equal, and each of
   its three launches against its own plain stage. K3 on float32
   activations at 96 to 768 takes the wgmma kernel too: held the same way
   at each of those widths, at 100 and 2,000 rows. Then the mma.sync
   kernel, off the main paths, the route forced (K3 in bf16 at 1024 and
   1536 and on float32 at 96, 1024 and 1536: the yardsticks the Hopper
   kernels are timed beside), at 2,000 rows, and K2 on float32 on the
   Hopper kernel, bit-equal to ``dwconv.cu``; the launch counters show
   which kernel each call took.
   Then the training path's kernels at the same shapes: K2 wgrad on its
   Hopper kernel (``dwconv_wgrad_hopper.cu``) and on ``dwconv_wgrad.cu``
   (the route forced) against its plain version relative to Σ|x·g| and
   bit-equal over two runs (flipped or transposed taps must land outside),
   the Hopper kernel again at the odd shapes and on float32 inputs, K2 dx
   (the
   routed forward kernel on flipped taps, through the autograd Function) against
   autograd through the plain conv, and K3 train (out bit-equal to the
   eval kernel's; t, h_pre and m by K3's rule, with m saved without b2
   and h_pre saved after GELU landing outside).
3. Run the serving forward (``CollisionPredictor`` with the default
   ``ExperimentConfig``: convnext_tiny + bi-GRU, seeded weights with γ
   re-drawn of order 1, biases and LayerNorms redrawn, and ``fc_out``
   scaled so the probabilities spread) on a seeded uint8 batch
   [8, 25, 126, 224, 3], each clip of its own level and contrast, through
   ``_make_forward(folded_stride=True)``. Check the probabilities and their
   spread across clips, that K1 launched once and K2 and K3 18 times each,
   and that the result matches the same forward with every kernel swapped
   for its plain version; then that the plain forward with a dropped K2 or
   K3 bias lands outside that tolerance (smaller faults are reported).
   Every K2 launch must take its Hopper kernel. Then the same forward at
   ``data.frame_size`` 112 on [8, 25, 63, 112, 3] (stages of 28, 14, 7 and
   4 after flax's SAME padding): launch counts and agreement with plain
   versions.
4. Time each kernel, its plain version, cuDNN's depthwise conv beside K2
   and its ``convolution_backward`` beside K2 wgrad (``library_ms``; K2's
   and K2 wgrad's Hopper kernels and ``dwconv.cu`` / ``dwconv_wgrad.cu`` in
   turns, each its own entry of the kernels line, with a per-stage table;
   K1 also at the ViViT's shape), the stock LN→Linear→GELU→Linear chain beside K3 (for
   information; it is not one call), K3's mma.sync kernel on the same
   inputs (``mma_sync_ms``), and the whole forward (both kernels,
   K2 only, K3 only, stock blocks) with CUDA events, as medians after
   warm-up; each kernel call (not the forwards) queued behind a
   device-side wait, so that the host's time to issue it is not timed.
5. Profile three forwards with ``torch.profiler``: device time by kernel
   and the device's idle share.
6. Run one training step (``create_train_state(ExperimentConfig())`` and
   ``make_train_step``: convnext_tiny + bi-GRU, bf16, default
   augmentation) on a seeded uint8 batch [8, 50, 126, 224, 3] with all
   three classes: launch counts (K2 36, K2 wgrad 18, K3 train 18, K3 eval
   and K1 0), a finite loss, a finite gradient for every parameter and a
   nonzero one for every block parameter. The same step with every kernel
   swapped for its plain version must agree on the loss and each
   gradient (TRAIN_TOL), where γ's gradient off by 1% and a dropped K2
   bias gradient must not; the loss must fall over five steps on a fixed
   batch with augmentation off.
7. Time the training step with kernels and with stock blocks in turns,
   ``train_preprocess`` alone and the step's peak memory; profile one
   step: device time of K2 (forward and dx), K2 wgrad, K3 train, K3's
   torch backward, ``train_preprocess`` and the rest, the idle share, and
   the torch ops' kernels under K2's backward; K2's bias gradient summed from
   a float32 copy of g against summed as read, timed at the stage shapes.

8. Hold K4's kernels (flash attention forward, backward dK/dV, backward
   dQ, and the backward's row kernel di = Σ o·do; at head_dim 64 and 16
   on Hopper kernels, bf16 and, as split bf16 products, float32; the
   counters showing which route each call took) against
   ``flash_mha_plain``, its written-out backward and ``_row_dot`` at
   [256, 576, 6, 64] bf16 (the scaled ViViT configuration), [64, 576, 6,
   64], [16, 1024, 6, 64], [8, 576, 12, 64], ragged lengths 577 and 200,
   the lengths on the edges of the backward's 64-, 128- and 192-row tiles
   (1, 63, 65, 127, 129, 193, 1030), float32 inputs, then float32 at
   [256, 576, 6, 64] and the same lengths, then head_dim 16 in bf16 and
   float32 at vivit_tiny's [256, 256, 4, 16], on the edges of its
   kernels' 64- and 128-row tiles (1, 63, 65, 127, 129, 255, 257, 385), at
   200 and at a length of 4: o and the log-sum-exp, dq, dk, dv on their
   largest and mean
   error (FLASH tolerances in ``flash_tols``; float32 2^-14 of the
   largest value), di within 2^-20 of Σ|o·do|, the backward bit-equal
   over two runs, strided views read without a copy (bf16 and float32),
   unsupported shapes refused. Faulty plain versions (the scale dropped,
   keys past S attended, the last key tile out of the normaliser, di left
   out of ds, do's last 8 columns left out of di; on float32 also every
   product on its operands' bf16 halves alone) must land outside. (Run
   with phase 2.)
9. Run the scaled ViViT configuration's serving forward (vivit_small, 32
   frames of 336², ``attention_impl="flash"``) through
   ``CollisionPredictor._make_forward(folded_stride=False)`` on a seeded
   uint8 batch [8, 32, 189, 336, 3]: launches K1 1, K4 fwd 8, all else 0;
   probabilities that spread; agreement with the same forward on plain
   versions, where the scale dropped in one block must not agree.
10. Time K4's kernels (the di kernel beside ``_row_dot``, the forward
    beside the mma.sync kernel, ``mma_sync_ms``), their plain versions and
    ``F.scaled_dot_product_attention`` forward and backward
    (``library_ms``); the float32 kernels at [256, 576, 6, 64], each on
    split copies made beforehand, their split pass (``K4 split``, the
    forward's of q, k, v and the backward's of q, k, v, do) and the
    CUDA-core kernels on the same inputs (``cuda_core_ms``), beside SDPA
    in float32; head_dim 16's Hopper kernels at vivit_tiny's [256, 256,
    4, 16] in bf16 and float32, beside the kernels they replaced on the
    same inputs (the route forced: ``mma_sync_ms``, ``cuda_core_ms``),
    their split pass, SDPA, their bounds and the exponentials' floor
    (``exp_floor_ms``, at ``nvidia-smi``'s largest SM clock); the
    ViViT forward with "flash" and "xla" attention in turns, its peak
    memory and profile.
11. Run one training step of the scaled configuration
    (``create_train_state``, ``make_train_step``, default augmentation
    with blur off) on a uint8 batch [8, 32, 189, 336, 3]: launches K4 fwd
    8, dK/dV 8, dQ 8, di 8; every parameter a finite gradient, every spatial
    block's projections a nonzero one; the step on plain versions must
    agree (VIVIT_TRAIN_TOL), where di left out of dQ's ds and dv off by 10%
    must not; both bf16 steps against the same step in float32 (K4 on its
    plain float32 version, remat on), where the kernel step's temporal
    query/key gradients must be no further from it than twice the plain
    step's; the loss must fall on a fixed batch; ``remat`` on and off
    must agree at B=2. Then the step with "flash" and "xla" in turns,
    peak memory and profile.
12. Save phase 3's predictor with ``CheckpointStore`` as ``best`` and load
    it on the card with ``CollisionPredictor.from_checkpoint(run_dir)``:
    probabilities on phase 3's batch bit-equal to the original's; a
    checkpoint with block 0's γ × 1.01 must not be bit-equal, and one whose
    hyperparams name convnext_base must fail the strict load. Save and
    load seconds, file size.
13. Serve from a loader: a stand-in dataset of 32 seeded uint8 clips
    [25, 126, 224, 3] (no decoder; clip 5 flagged ``error``) through
    ``ClipLoader(batch_size=8)``, ``device_feed`` (pinned ring, side
    stream) and ``_predict_batches``: launches K1 4, K2 72, K3 72; each
    result bit-equal to ``_make_forward(True)`` fed the same clips, clip 5
    ``success: False``; the same with every copy landing late behind a
    device-side wait. A feed that hands batches over before their copy
    and refills its ring early, and a loader that repeats the previous
    batch's frames, must not agree. The loop against the forward alone
    over 4 and 16 batches in turns (clips/s), the pinned copy of one
    batch, the share of a copy the loop hides (from what a batch more
    costs each), the pipeline's fill, the loop's profile.
14. The sliding forward: ``_sliding_forward`` over a seeded pool of 300
    letterboxed frames [300, 224, 224, 3] (30 s at 10 fps, a window each
    second: 26 windows of 50 frames, padded to 320 frames and 32
    windows, gathered on the card): launches K1 1, K2 18, K3 18; each
    window within 1e-4 of ``_make_forward(False)`` on the same 32 windows
    gathered on the host, and within 2e-2 of it fed 8 windows a call;
    every kernel swapped for its plain version within 2e-2;
    windows shifted by one frame must land outside 1e-4. Time, windows/s,
    peak memory.
15. Where ``pkg-config --exists libavformat`` answers, build the port's
    media library, encode three clips and run ``predict``,
    ``predict_sliding`` and ``evaluate`` on them; elsewhere print
    ``{"decode": "not run: no FFmpeg on this machine"}``.
16. The ``Trainer`` at full width (the flagship ``ExperimentConfig()``
    with ``validation_freq`` 2 and a checkpoint each epoch) over stand-in
    datasets of seeded content clips [50, 126, 224, 3] in all three
    classes (16 training clips, one flagged ``error``; 8 validation, 8
    test): 2 epochs with the mini-validation cascade inside each, a new
    ``Trainer`` resuming for epoch 3, then ``test()``. Launch counts per
    step (K2 36, K2 wgrad 18, K3 train 18) and per evaluation batch (K1 1,
    K2 18, K3 eval 18), all on the Hopper kernels; the artifacts parsed
    with the ``csv`` and ``json`` modules; epoch 0's losses against
    ``make_train_step`` driven directly on the same batches with the same
    generator seeds; the resumed run against an uninterrupted 3-epoch run
    (losses, parameters, epoch 3's update), where a resume that drops the
    AdamW moments or restarts ``step`` at 0 must land outside;
    ``from_checkpoint`` on the run directory bit-equal to ``test()``'s
    probabilities. The loop against ``make_train_step`` on batches already
    on the card over 16 steps in turns, its idle share, the 33.9 MB copy,
    a checkpoint save, one evaluation batch, peak memory. One step with
    ``model.use_sensor`` on a seeded sensor stream [8, 50, 4] against the
    plain step. Then, under torch's default cuDNN flags (for this phase
    only), the GRU head pinned and unpinned against a float64 copy, the
    caller's flags before and after, and the serving forward against the
    same forward under this script's TF32 switch (bit-equal).

17. Serve a reference checkpoint: the reference's default architecture
    (ConvNeXt-tiny, 2-layer bidirectional GRU of 512, the BatchNorm
    classifier) in plain torch with the reference's module names, seeded
    weights and random BatchNorm statistics, saved as a reference-format
    ``.pth`` and loaded with ``CollisionPredictor.from_torch_checkpoint``
    in float32 on the card; ``_make_forward(folded_stride=True)`` on seeded
    uint8 clips [8, 25, 126, 224, 3] of distinct content. On default
    switches (K3 only on bf16 activations): launches K1 1, K2 18 on
    ``dwconv_hopper.cu``'s float32 route, no K3; against the same forward
    on plain versions and the reference module in float64 (1e-4 each);
    the stock float32 blocks against float64 (1e-4) and bit-equal under
    torch's default cuDNN flags; faults (the classifier BatchNorm's
    running variance set to 1, the GRU's r and z gates swapped) must land
    outside. With ``fused_mlp=True``: K1 1, K2 18, K3 18 on
    ``convnext_mlp_wgmma.cu``'s float32 route, against plain versions
    (2e-2) and float64 (5e-2: K3's bf16 rounding). K2 and K3 on float32
    at the stage shapes (``f32_kernels``): K2's Hopper route bit-equal to
    ``dwconv.cu`` and within 2^-16 of its plain version, K3's eval and
    train by K3's rule on the Hopper kernel and on ``convnext_mlp.cu``
    (the route forced), with faults; each timed in turns with the kernel
    it replaced, beside cuDNN or the stock float32 chain and the plain
    version; both legs against stock blocks and the bf16 model, in
    turns.
18. The seven BatchNorm backbones with the flagship head in bf16, served
    (K1 once, nothing else launched), timed, peak memory; one training step
    of resnet50 + the conv head on a uint8 batch [8, 50, 126, 224, 3]:
    finite loss and gradients, two BatchNorms' updates holding the batch's
    biased statistics read back from the captured inputs, where torch's
    unbiased update must land outside; ms per step and peak memory; the
    committed mobilenet_v3_small fixture loaded with its ``batch_stats``,
    3 steps on a fixed batch with a falling loss.
19. ConvNeXt-tiny (bf16) with the attention, conv, pooling, rnn and lstm
    heads: each serving forward against plain versions (1e-1, where a
    dropped K2 bias must land outside; launches K1 1, K2 18, K3 18 on the
    Hopper kernels) and timed, each training step
    against the plain step (TRAIN_TOL; K2 36, K2 wgrad 18, K3 train 18) and
    timed.

20. Data parallelism (``parallel/``), its ranks child processes of this
    script with torchrun's variables (``--rank``), this process holding no
    process group. (a) World size 1 over NCCL: the flagship's
    ``DataParallelStrategy`` step (DDP with the summing hook) on uint8
    [8, 50, 126, 224, 3] bit-equal to ``make_train_step`` from the same
    weights and generator (launches K2 36, K2 wgrad 18, K3 train 18), both
    timed in turns (DDP's own overhead), the DP evaluation's gathered
    probabilities bit-equal to ``make_eval_step``'s. (b) Two ranks sharing
    the card over gloo, 4 clips each (augmentation and dropout off),
    against one device on all 8: loss, every gradient and parameter within
    5e-3 relative; gradients averaged (DDP's own hook) must land outside;
    the GRU's frozen torch biases still 0. (c) resnet18 with the conv head
    (BatchNorm in both), two ranks: the running statistics bit-equal on the
    ranks and within 1e-6 of the mean of the ranks' own single-device
    updates, which differ. (d) ``Trainer`` with ``DataParallelStrategy``,
    two ranks, per-device batch 4: one epoch of 2 steps, the validation
    gather, ``best`` and ``last`` written once by rank 0, ``test()`` on 7
    clips (the wrap pad trimmed); ``from_checkpoint`` on one card
    bit-equal to rank 0's ``test()`` probabilities. ms per step of (b) and
    (d) are of two processes sharing one card: a correctness run, not a DP
    speed.
21. Tensor parallelism: the scaled ViViT (vivit_small, 32 frames of 336²,
    ``"flash"``, bf16, blur off; biases and LayerNorms redrawn, the head
    scaled) over a model group of 2 ranks sharing the card over gloo, B=8:
    one ``ModelParallelStrategy`` step against one device's (4e-2, the
    temporal query/key 1e-1) with K4's four kernels launched 8 times a rank
    on 3 of the 6 heads; the out projection's bias added on both ranks must
    land outside; the TP forward's probabilities within 2e-2 of one
    device's; the gathered checkpoint served by ``from_checkpoint`` on one
    card, bit-equal to one device's forward of the gathered weights.
22. Serving bundles (``infer/aot.py``): phase 3's predictor (buckets 1, 8,
    32) and phase 10's ViViT (buckets 1, 8) exported with ``torch.export``
    (one program, its batch dynamic) under ``build/`` and served by
    ``ServingBundle``: export s and bytes, cold start in a fresh process
    against ``from_checkpoint`` in another, each bucket and a 9-clip
    request against ``_make_forward`` within 1e-6, one bucket-8 call's
    launches (K1 1, K2 18, K3 18; K1 1, K4 fwd 8), the program without
    the bundle's float32 pin under torch's default cuDNN flags outside
    1e-6, ms at bucket 8 against the forward in turns, the flagship
    forward through the ``torch.library`` ops against the same calls
    straight to the ops' implementations, in turns; then
    ``cli.convert_weights --full`` on phase 17's ``.pth`` in a child
    process, its ``.npz`` served bit-equal to phase 17.
23. The attention view (``obs/viz.py``): phase 19's ConvNeXt-tiny +
    attention model (bf16), its query and key projections scaled so the
    attention logits spread over the keys, on seeded uint8 clips [8, 25,
    126, 224, 3] whose frames differ, through eval preprocessing and
    ``extract_attention_weights``: launches K1 1, K2 18, K3 18 on the
    Hopper kernels and nothing else; logits bit-equal to the forward;
    rows summing to 1; the per-frame importance [8, 25] and the full
    matrix [8, 4, 25, 25] against the same call on plain versions, where
    the previous call's matrix (another batch) and the mean over keys must
    land outside; the view against the forward in turns; the overlay's
    frames on clip 0. The MP4, HTML and PNG only where FFmpeg and
    matplotlib exist (elsewhere one "not run" line). Then
    ``scripts/run_training_torch.sh distributed 4`` through a recording
    PYTHON (``--nproc-per-node`` the card count, the global batch echoed)
    and, where FFmpeg exists, its ``check``.
24. ConvNeXt base and large (``ExperimentConfig()`` with only
    ``model.backbone`` changed; bf16): one ``make_train_step`` of
    ``create_train_state``'s model on uint8 [8, 50, 126, 224, 3] (K2 72,
    K2 wgrad 36, K3 train 36: 33 on the wgmma kernel, the last stage's 3
    at C = 1024 or 1536 on the split kernel) against the plain step,
    where a 1% dγ and a dropped K2 db must land outside; the same model,
    weights redrawn, served through ``_make_forward(folded_stride=True)``
    on uint8 [8, 25, 126, 224, 3] (K1 1, K2 36, K3 36: 33 on the wgmma
    kernel, 3 on the split kernel) against plain versions, where a
    dropped K2 or K3 bias must land outside; ms per step and per batch
    with peak memory; each stage's K2 forward, dx and wgrad and K3 eval
    and train at the full stage shape against their plain versions, with
    their faults, and timed beside their bounds (the split kernel also
    beside ``convnext_mlp.cu`` on the same inputs, the stock chain and
    its plain version).
25. Float32 training. K2 wgrad on float32 at the four stage shapes on its
    Hopper route (``dwconv_wgrad_hopper.cu``) and on ``dwconv_wgrad.cu``
    (the route forced), relative to Σ|x·g| and bit-equal twice, flipped
    and swapped taps outside, then at an odd shape and a width of 40
    (``dwconv_wgrad.cu``, its route); K3 on float32 at [9800, 1024] and
    [9800, 1536] on the split kernel's float32 route, eval and train, both
    GELU forms, with K3's faults, twice bit-equal and stage by stage; each
    timed in turns with the kernel it replaces on the same inputs, beside
    its plain version and cuDNN's float32 ``convolution_backward`` (wgrad)
    or the stock float32 chain (K3). Then the flagship with only
    ``model.dtype="float32"`` at default switches: one step (K2 36 and K2
    wgrad 18 on the float32 Hopper routes, no K3: a float32 block's
    default is the stock MLP) against the plain step (TRAIN_TOL), where a
    dropped K2 db and K2's dw off by 1% must land outside; the step timed
    in turns with the bf16 flagship's, peak memory. Then ConvNeXt base and
    large in float32 built with ``fused_mlp=True``: one step (K2 72, K2
    wgrad 36, K3 train 36: 33 on the wgmma kernel's float32 route, 3 on
    the split kernel's) against the plain step (1% dγ, a dropped K2 db,
    1% dw outside) and the serving forward (K1 1, K2 36, K3 36, 3 split)
    against plain versions, each timed with peak memory.
26. The scaled ViViT in float32 (phases 9 and 11's configuration with
    ``model.dtype="float32"``; ``python3 chip_smoke.py --phase 26`` runs
    it alone, through ``float32_vivit_phase(torch, dev)``). Serving on
    phase 9's batch: launches K1 1, K4 fwd 8 on the float32 kernel, each
    after a split pass (K4 split 8); probabilities that spread; within 1e-4 of the forward
    on plain versions, where a scale dropped in block 1 or 8 must not be;
    ms per batch in turns with float32 "xla" and bf16 "flash", peak
    memory. Training, one step on phase 11's batch: K4 fwd, dK/dV, dQ and
    di 8 each, on the float32 kernels, and K4 split 16 (one a forward, one
    a backward for both its kernels); finite gradients, nonzero for every
    spatial block's projections; loss and gradients within 1e-3 of the
    plain float32 step (remat on), where di left out of dQ's ds and dv off
    by 1% must not be; the loss falling on a fixed batch; ms per step in
    turns with float32 "xla" and bf16 "flash", peak memory.
27. vivit_tiny with ``attention_impl="flash"`` (phase 9's configuration
    with ``model.backbone="vivit_tiny"`` and 224² frames: 256 tokens, 4
    heads of 16, 2 spatial blocks; ``python3 chip_smoke.py --phase 27``
    runs it alone), in bf16 and in float32: serving on a seeded uint8
    batch [8, 32, 126, 224, 3] (launches K1 1 and K4 fwd 2 on the
    head_dim-16 Hopper kernels; float32 also K4 split 2), probabilities
    that spread, within 2e-2 (bf16) and 1e-4 (float32) of the forward on
    plain versions, the scale dropped in block 1 or 2 outside; one
    training step on phase 11's batch at 224² (K4 fwd, dK/dV, dQ and di 2
    each; float32 also K4 split 4) against the plain step (bf16 4e-2, the
    temporal query/key 1e-1; float32 1e-3), di left out of dQ's ds and dv
    off (× 1.10 bf16, × 1.01 float32) outside; the forward and the step
    in turns with "xla", peak memory.
28. The fused training preprocess (``ops/csrc/train_preprocess.cu``;
    ``python3 chip_smoke.py --phase 28`` runs it alone): against the chain
    from the same seed at 189×336 → 336 and 126×224 → 224, every
    augmentation step forced on in turn, both warps, bf16 and float32
    out, at 4 clips of 3 frames; and at the main paths' batches, [8, 32,
    189, 336, 3] and [8, 50, 126, 224, 3] (several groups of frames a
    clip, the last one partial), with the draws, skip and cutout; within 2^-6 + 2·2^-8/0.225 (posterize 32/255/0.225 more) at most
    and 1e-5 on the mean; a faulty table (hue + 0.02, flips inverted, rows
    shifted, contrast means at 0) outside; timed at [8, 32, 189, 336, 3]
    and [8, 50, 126, 224, 3] in turns with the chain, with the bound.
29. TimeSformer-HR (``model.backbone="timesformer_hr"``, 16 frames of
    448², patch 16, ``attention_impl="flash"``; ``python3 chip_smoke.py
    --phase 29`` runs it alone), bf16: K4 at the model's two calls,
    [128, 785, 12, 64] and [8, 16, 9408, 64], against its plain versions
    (the bf16 rule of phase 2) and timed; serving on a seeded uint8 batch
    [8, 16, 252, 448, 3] (launches K1 1, K4 fwd 24: a temporal and a
    spatial call a block), probabilities that spread, within 1e-1 of the
    forward on plain versions, the gap of the centred log-probabilities
    to the published forward in float32 recorded; one training step at
    B=8 (K4 fwd, dK/dV, dQ and di 24 each, the fused preprocess 2; every
    gradient finite, every attention's projections nonzero), ms a step,
    peak memory; the step against the plain step at 2 clips (4e-2, query
    and key 1e-1).

Prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOPS = 989e12            # dense tensor-core bf16
F32_FLOPS = 67e12              # CUDA-core float32 (FMA = 2 flops)

N_FRAMES = 200                 # B=8 clips × 25 folded frames
CONTENT = (126, 224)           # 16:9 source letterboxed into 224²
K1_SIDE_CONTENT = (120, 213)   # bars on all four sides, rows of 639 bytes
S = 224
STAGES = ((56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3))  # (H=W, C, blocks)
LOGIT_SCALE = 10.0             # fc_out weights × this in the serving forward
# The serving forward against the same forward on plain versions, max
# |Δprob|: bf16 activations through 18 blocks, where 1-ulp flips between
# kernel and plain sums propagate. With ``fc_out`` rescaled so that the
# clips' logits spread (``spread_logits``; phase 24, whose seeded clips sit
# together near one class otherwise) the flips reach the probabilities
# about ten times further (ConvNeXt base 6.2e-2, large 6.4e-2 on an H100,
# where base read 6.5e-3 without the rescale): phase 19's 1e-1 for spread
# logits.
SERVE_TOL = 2e-2
SPREAD_SERVE_TOL = 1e-1
SPREAD_MIN = 0.05              # least spread of one class's probability across clips
WGRAD_TOL = 1e-6               # K2 wgrad error per tap and channel / Σ|x·g|
# Kernel step vs plain step: the loss and each parameter's gradient,
# relative (to the loss, to that gradient's norm). The two share every
# rounding but the kernels' sum order, so they differ by rare 1-ulp flips;
# γ's gradient off by 1% must land outside.
TRAIN_TOL = 5e-3
STEPS_PER_EPOCH = 100
TRAIN_SEED = 5                 # the step's generator (flips, augmentation, dropout)
TRAIN_FALL_STEPS = 5
VIVIT_FALL_STEPS = 20
TRAIN_TIME_ITERS = 5


def log(*a):
    print(*a, flush=True)


# A device-side wait (about 1 ms on an H100) that each timed call is queued
# behind: the host issues the call while the device waits, so the events
# time the device's work and not the host's time to issue it, which is the
# longer of the two for a short kernel (K1 takes about 35 µs).
WAIT_CYCLES = 2_000_000


def median_ms(torch, fn, warmup=3, iters=10, queued=True):
    """Median over ``iters`` calls of ``fn``, CUDA events around each, after
    ``warmup`` calls. ``queued``: each call waits behind WAIT_CYCLES on the
    device; off for the forwards, whose host time users see."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if queued:
            torch.cuda._sleep(WAIT_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def in_turns_ms(torch, new, old):
    """ms per call of ``new`` and ``old`` (each a no-argument call), timed
    in turns (new, old, old, new): the mean of each one's two medians."""
    n1, o1, o2, n2 = (median_ms(torch, fn) for fn in (new, old, old, new))
    return (n1 + n2) / 2, (o1 + o2) / 2


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    report["build_s"] = time.time() - t0
    log(f"[build] {lib_path} in {report['build_s']:.1f} s")
    for logf in sorted(lib_path.parent.glob("*.log")):
        function = None
        for line in logf.read_text().splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            if any(w in line for w in ("registers", "spill", "wgmma")):
                log(f"[ptxas {logf.stem}] {line.strip()}")
            # which function spills: the line before names it
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and spill.groups() != ("0", "0"):
                log(f"[ptxas {logf.stem}] spills in {function}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    log(f"[card] {smi_line}")
    report["card"] = smi_line

    compare = compare_kernels(torch, dev)
    report["compare"] = compare
    report["compare_train"] = compare_train_kernels(torch, dev,
                                                    compare["inputs"])
    flash = compare_flash_kernels(torch, dev)
    report["compare_flash"] = {"rows": flash["rows"],
                               "faults": flash["faults"]}
    serve = serving_forward(torch, dev)
    report["serving"] = serve["summary"]
    timing = time_kernels(torch, dev, compare["inputs"])
    del compare["inputs"]
    report["timing"] = timing

    forward_ms = time_forward(torch, serve)
    report["forward"] = forward_ms
    report["profile"] = profile_device(
        torch, "forward", lambda: serve["forward"](serve["frames"]), 3,
        {"K1": "dequant_pad_rows", "K2": "dwconv7x7_hopper_kernel",
         "K2 dwconv.cu": "dwconv7x7_kernel",
         "K3": "convnext_mlp_wgmma_kernel"})
    # phase 3's predictor and batch, for phases 12 to 14
    flagship = {"pred": serve["pred"], "frames": serve["frames"]}
    del serve
    # 112² frames, as train/notebook.py suggests: stages of 28, 14, 7 and 4
    # rows, the last after a SAME pad of (0, 1)
    serve112 = serving_forward(torch, dev, size=112, content=(63, 112),
                               tag="serve 112", power=False)
    report["serving_112"] = serve112["summary"]
    del serve112

    train = training_step(torch, dev)
    report["training"] = train["summary"]
    report["train_time"] = time_training(torch, dev, train)
    report["train_profile"] = profile_training(torch, train)

    launches = {"serve": report["serving"]["launches"],
                "train": train["summary"]["launches"]}
    del train
    torch.cuda.empty_cache()

    flash_timing, report["flash_by_shape"] = time_flash_kernels(
        torch, dev, flash["inputs"])
    route_timing, report["flash_routes"] = time_flash_routes(
        torch, dev, flash["inputs"])
    del flash["inputs"]
    report["timing"] = timing + flash_timing + route_timing
    vserve = vivit_serving(torch, dev)
    report["vivit_serving"] = vserve["summary"]
    report["vivit_forward"] = time_vivit_forward(torch, vserve)
    # phase 10's predictor and batch, for phase 22
    vivit = {"pred": vserve["pred"], "frames": vserve["frames"]}
    del vserve
    torch.cuda.empty_cache()
    vtrain = vivit_training(torch, dev)
    report["vivit_training"] = vtrain["summary"]
    report["vivit_train_time"] = time_vivit_training(torch, dev, vtrain)
    launches["vivit_serve"] = report["vivit_serving"]["launches"]
    launches["vivit_train"] = vtrain["summary"]["launches"]
    del vtrain
    torch.cuda.empty_cache()

    report["checkpoint"] = checkpoint_phase(torch, dev, flagship)
    report["predict_loop"] = predict_loop(torch, dev, flagship["pred"])
    launches["predict"] = report["predict_loop"]["launches"]
    report["sliding"] = sliding_phase(torch, dev, flagship["pred"])
    launches["sliding"] = report["sliding"]["launches"]
    report["decode"] = decode_phase(torch, dev, flagship["pred"])
    report["trainer"] = trainer_phase(torch, dev, flagship)
    launches["trainer"] = report["trainer"]["launches"]
    torch.cuda.empty_cache()

    t0 = time.time()
    ref = reference_phase(torch, dev, flagship["frames"])
    reference = ref.pop("served")  # phase 17's .pth and reading, for 22
    report["reference"] = ref
    launches["reference"] = ref["launches"]
    launches["reference_fused"] = ref["launches_fused"]
    launches["reference_bf16"] = ref["launches_bf16"]
    bn = bn_backbones_phase(torch, dev, flagship["frames"])
    report["bn_backbones"] = bn
    launches["bn_serve"] = bn["launches"]
    launches["bn_train"] = bn["train"]["launches"]
    heads = heads_phase(torch, dev, flagship["frames"])
    report["heads"] = heads
    launches["heads"] = heads["launches"]
    report["phases_17_19_s"] = time.time() - t0
    log(f"[phases 17-19] {report['phases_17_19_s']:.1f} s")
    torch.cuda.empty_cache()
    report["parallel"], parallel_launches = parallel_phases(torch, dev)
    launches.update(parallel_launches)
    t0 = time.time()
    report["bundles"], bundle_launches = bundle_phase(
        torch, dev, flagship, vivit, reference)
    launches.update(bundle_launches)
    report["phase_22_s"] = time.time() - t0
    log(f"[phase 22] {report['phase_22_s']:.1f} s")
    report["attention_view"] = attention_view_phase(torch, dev)
    launches["attention_view"] = report["attention_view"]["launches"]
    log(f"[phase 23] {report['attention_view']['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    big = big_convnext_phase(torch, dev)
    report["big_convnext"] = big
    launches.update(big["launches"])
    log(f"[phase 24] {big['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    f32_train = f32_training_phase(torch, dev)
    report["f32_training"] = f32_train
    launches.update(f32_train["launches"])
    log(f"[phase 25] {f32_train['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    vivit32 = float32_vivit_phase(torch, dev)
    report["vivit_f32"] = vivit32
    launches.update(vivit32["launches"])
    log(f"[phase 26] {vivit32['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    tiny = vivit_tiny_phase(torch, dev)
    report["vivit_tiny"] = tiny
    launches.update(tiny["launches"])
    log(f"[phase 27] {tiny['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    pre = fused_preprocess_phase(torch, dev)
    report["fused_preprocess"] = pre
    log(f"[phase 28] {pre['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    tsf = timesformer_phase(torch, dev)
    report["timesformer"] = tsf
    launches.update(tsf["launches"])
    log(f"[phase 29] {tsf['phase_s']:.1f} s")

    kernels = kernel_line(
        compare["rows"] + report["compare_train"]["rows"] + flash["rows"]
        + ref["compare_rows"] + big["compare_rows"]
        + f32_train["compare_rows"] + pre["compare"] + tsf["compare"],
        launches,
        report["timing"] + ref["kernel_timing"] + [
            r for r in big["timing"] if r["kernel"].endswith("(wide)")]
        + f32_train["timing"] + pre["timing"][:1])
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---- 2. kernel vs plain ------------------------------------------------

def k3_params(torch, C, g, dev):
    def n(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=g.device)
                * std).to(dev)

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=g.device)
                + 0.5).to(dev)

    return dict(ln_w=u(C), ln_b=n(C, std=0.1), w1=n(C, 4 * C, std=C ** -0.5),
                b1=n(4 * C, std=0.1), w2=n(4 * C, C, std=(4 * C) ** -0.5),
                b2=n(C, std=0.1), gamma=u(C))


def mean_err(torch, a, b):
    return float((a.float() - b.float()).abs().mean())


def recorder(rows, failed):
    """→ record(name, shape, err, tol, ...): one comparison of a kernel with
    its plain version, appended to ``rows`` and, when outside its
    tolerance, to ``failed``. ``err`` is what ``tol`` bounds; ``abs_err``
    (default ``err``) is the largest absolute difference; ``entry`` is the
    kernel's key in the kernels line (default the name's first word)."""
    def record(name, shape, err, tol, mean=None, mean_tol=None,
               abs_err=None, entry=None):
        ok = err <= tol and (mean is None or mean <= mean_tol)
        rows.append({"kernel": name, "entry": entry or name.split()[0],
                     "shape": shape, "err": err, "tol": tol,
                     "max_abs_err": err if abs_err is None else abs_err,
                     "mean_abs_err": mean, "mean_tol": mean_tol, "ok": ok})
        extra = "" if mean is None else (
            f", mean_abs_err {mean:.3e} (tol {mean_tol:.3e})")
        log(f"[compare] {name} {shape}: err {err:.3e} "
            f"(tol {tol:.3e}){extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {shape}")
    return record


def fault_seen(faults, failed, name, shape, seen, **numbers):
    """Record whether a fault written into a plain version lands outside the
    tolerance it is meant to test; a fault not seen fails the run."""
    faults.append({"fault": name, "shape": shape, "seen": seen, **numbers})
    log(f"[compare] fault {name} {shape}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in numbers.items())
        + f": {'seen' if seen else 'NOT seen'}")
    if not seen:
        failed.append(f"fault {name} not seen at {shape}")


@contextlib.contextmanager
def swapped(*swaps):
    """Set each (module or class, attribute, value) for the block, then
    restore what was there."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def old_route(module):
    """The swap that sends K2 (``dwconv``) or K3 (``convnext_mlp``) to its
    older kernel, ``dwconv.cu`` or ``convnext_mlp.cu`` (the float32 routes'
    kernels before the Hopper kernels took them)."""
    return (module, "route", lambda dtype, C_: "tile"
            if module.__name__.endswith("dwconv") else "mma")


# Faults a K3 could have, written as changes to what its plain version is
# given: (parameters, approximate) → (parameters, approximate). A check has
# power where the fault lands outside its tolerance and the kernel inside.
K3_ARGS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")
K3_FAULTS = {
    "gamma_1pct": lambda p, ap: (dict(p, gamma=p["gamma"] * 1.01), ap),
    "b2_dropped": lambda p, ap: (dict(p, b2=p["b2"] * 0), ap),
    # tanh for erf: less than a bf16 ulp of h apart, but in every row
    "gelu_form": lambda p, ap: (p, not ap),
}


def k3_entries(torch, C, dtype):
    """The kernels-line entries (eval, train) of K3 at width C on ``dtype``
    activations, by the kernel ``convnext_mlp.route`` sends it to: the
    Hopper kernel's and the split kernel's (their float32 routes have
    entries of their own), or the mma.sync kernel's, whose float32 eval is
    ``K3 (f32)`` and which has no other entry (it is off the main
    paths)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    f32 = dtype == torch.float32
    return {"wgmma": (("K3 (wgmma f32)", "K3 train (wgmma f32)") if f32
                      else ("K3", "K3 train")),
            "wide": (("K3 (wide f32)", "K3 train (wide f32)") if f32
                     else ("K3 (wide)", "K3 train (wide)"))}.get(
        k3.route(dtype, C),
        ("K3 (f32)" if f32 else "K3 (mma.sync)", "K3 train (mma.sync)"))


def check_k3_wide(torch, dev, g, C, M, record, failed, dtype=None):
    """The split kernel at [M, C] in ``dtype`` (default bf16) beyond
    ``check_k3_small``: two calls of each variant bit-equal, and each of
    its three launches (``ln_stage``, ``up_stage``, ``down_stage``) against
    its own plain version on the plain version's inputs, by K3's rule (m
    against the plain m rounded to bf16, as the kernel saves it)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    dtype = dtype or torch.bfloat16
    eval_entry, train_entry = k3_entries(torch, C, dtype)
    tag = "" if dtype == torch.bfloat16 else f" {str(dtype)[6:]}"
    xs = torch.randn(M, C, generator=g, device=g.device).to(dev, dtype)
    y = torch.randn(M, C, generator=g, device=g.device).to(dev, dtype)
    p = k3_params(torch, C, g, dev)
    with torch.no_grad():
        a, b = (k3.convnext_mlp(xs, y, approximate=False, **p)
                for _ in range(2))
    ta, tb = (k3.convnext_mlp_train(xs, y, approximate=False, **p)
              for _ in range(2))
    torch.cuda.synchronize()
    record(f"K3 wide twice width {C}{tag} (bit-equal)", [M, C],
           max_err(torch, a, b), 0.0, entry=eval_entry)
    record(f"K3 wide train twice width {C}{tag} (bit-equal)", [M, C],
           max(max_err(torch, u, v) for u, v in zip(ta, tb)), 0.0,
           entry=train_entry)
    del a, b, ta, tb
    t_ref = k3.ln_stage_plain(y, p["ln_w"], p["ln_b"])
    hp_ref, h_ref = k3.up_stage_plain(t_ref, p["w1"], p["b1"], False)
    out_ref, m_ref = k3.down_stage_plain(h_ref, xs, p["w2"], p["b2"],
                                         p["gamma"])
    got = {"ln t": k3.ln_stage(y, p["ln_w"], p["ln_b"])}
    got["up h_pre"], got["up h"] = k3.up_stage(t_ref, p["w1"], p["b1"],
                                               False)
    got["down out"], got["down m"] = k3.down_stage(h_ref, xs, p["w2"],
                                                   p["b2"], p["gamma"])
    torch.cuda.synchronize()
    refs = {"ln t": t_ref, "up h_pre": hp_ref, "up h": h_ref,
            "down out": out_ref, "down m": m_ref.to(torch.bfloat16)}
    for name, r in refs.items():
        if got[name].dtype != r.dtype:
            failed.append(f"K3 wide stage {name} width {C}{tag} wrote "
                          f"{got[name].dtype}, its plain version {r.dtype}")
        record(f"K3 wide stage {name} width {C}{tag}", [M, C],
               max_err(torch, got[name], r),
               float(r.float().abs().max()) * 2 ** -6,
               mean_err(torch, got[name], r),
               float(r.float().abs().mean()) * 2 ** -12, entry=eval_entry)


def check_k3_small(torch, dev, g, C, M, record, faults, failed,
                   dtype=None):
    """K3's eval and train variants against their plain version at [M, C]
    in ``dtype`` (default bf16), both GELU forms (K3's rule; the train
    variant's out bit-equal to the eval variant's), and K3's faults in the
    plain version, which must land outside. ``g`` may be a CUDA generator
    (the inputs are drawn there)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    dtype = dtype or torch.bfloat16
    eval_entry, train_entry = k3_entries(torch, C, dtype)
    xs = torch.randn(M, C, generator=g, device=g.device).to(dev, dtype)
    y = torch.randn(M, C, generator=g, device=g.device).to(dev, dtype)
    p = k3_params(torch, C, g, dev)
    for approximate in (True, False):
        with torch.no_grad():
            got = k3.convnext_mlp(xs, y, approximate=approximate, **p)
        train = k3.convnext_mlp_train(xs, y, approximate=approximate, **p)
        ref = k3.convnext_mlp_train_plain(xs, y, approximate=approximate, **p)
        torch.cuda.synchronize()
        tols = {}
        for name, v, r in zip(("out", "t", "h_pre", "m"), (got, *train[1:]),
                              ref):
            tols[name] = (float(r.float().abs().max()) * 2 ** -6,
                          float(r.float().abs().mean()) * 2 ** -12)
            record(f"K3 {name} width {C} {str(dtype)[6:]} "
                   f"approximate={approximate}", [M, C],
                   max_err(torch, v, r), tols[name][0],
                   mean_err(torch, v, r), tols[name][1],
                   entry=eval_entry if name == "out" else train_entry)
        record(f"K3 train out vs eval width {C} {str(dtype)[6:]} "
               "(bit-equal)", [M, C],
               max_err(torch, train[0], got), 0.0, entry=train_entry)
    # got, ref and tols are those of approximate=False
    for fault, change in K3_FAULTS.items():
        fp, fap = change(p, False)
        bad = k3.convnext_mlp_plain(xs, y, approximate=fap, **fp)
        err, mean = max_err(torch, bad, ref[0]), mean_err(torch, bad, ref[0])
        fault_seen(faults, failed, f"K3 {fault} width {C} {str(dtype)[6:]}",
                   [M, C],
                   err > tols["out"][0] or mean > tols["out"][1],
                   max_abs_err=err, mean_abs_err=mean)


# K2 beyond the four stages: the last stage of 112² frames (4×4) and of
# 40² frames (2×2, smaller than the kernel), odd sides, and a short wide
# frame (16×64) whose whole frame would not fit the Hopper kernels' shared
# memory, so it takes bands.
K2_ODD_SHAPES = ((N_FRAMES, 4, 4, 768), (64, 2, 2, 768), (64, 3, 5, 384),
                 (64, 10, 6, 96), (64, 16, 64, 96))


def k2_inputs(torch, dev, g, shape, dtype=None):
    """Seeded x [N, H, W, C], w [49, C] (taps of order 1/7) and b [C] in
    ``dtype`` (default bf16), drawn on ``g``'s device."""
    N, H, W, C = shape
    dtype = dtype or torch.bfloat16
    x = torch.randn(N, H, W, C, generator=g, device=g.device).to(dev, dtype)
    w = (torch.randn(49, C, generator=g, device=g.device) / 7).to(dev, dtype)
    b = (torch.randn(C, generator=g, device=g.device) * 0.1).to(dev, dtype)
    return x, w, b


def k2_entry(torch, x):
    """The kernels-line entry of the forward kernel ``dwconv.route`` picks."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    return ("K2 (hopper)" if k2.route(x.dtype, x.shape[-1]) == "hopper"
            else "K2")


def check_k2(torch, x, w, b, record, faults, failed):
    """K2's forward on the kernel of ``dwconv.route`` against its plain
    version, and bit-equal over two runs; the plain version on taps
    transposed (dy ↔ dx) must land outside; both launches must count on the
    routed kernel."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    shape = list(x.shape)
    entry = k2_entry(torch, x)
    before = k2.dwconv7x7.hopper_launches
    got = k2.dwconv7x7(x, w, b)
    again = k2.dwconv7x7(x, w, b)
    ref = k2.dwconv7x7_plain(x, w, b)
    torch.cuda.synchronize()
    # float32 sums in another order, then one bf16 rounding: 1 ulp at the
    # largest magnitude
    tol = float(ref.float().abs().max()) * 2 ** -7
    record(entry, shape, max_err(torch, got, ref), tol, entry=entry)
    record(f"{entry} twice (bit-equal)", shape, max_err(torch, got, again),
           0.0, entry=entry)
    C = x.shape[-1]
    taps_t = w.view(7, 7, C).transpose(0, 1).reshape(49, C).contiguous()
    err = max_err(torch, k2.dwconv7x7_plain(x, taps_t, b), ref)
    fault_seen(faults, failed, f"{entry} taps transposed", shape, err > tol,
               max_abs_err=err)
    if k2.dwconv7x7.hopper_launches - before != 2 * (entry != "K2"):
        failed.append(f"{entry} {shape} did not take the routed kernel")


def check_k2_dx(torch, x, w, b, gy, record, failed):
    """K2's dx (the routed forward kernel on flipped taps, zero bias,
    through the autograd Function) against autograd through the plain
    conv."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    entry = k2_entry(torch, x)
    before = k2.dwconv7x7.hopper_launches
    xr = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(k2.dwconv7x7(xr, w, b), xr, gy)
    xp = x.detach().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(k2.dwconv7x7_plain(xp, w, b), xp, gy)
    torch.cuda.synchronize()
    # float32 sums of 49 taps in another order, one bf16 rounding
    record(f"{entry} dx", list(x.shape), max_err(torch, dx, dx_ref),
           float(dx_ref.float().abs().max()) * 2 ** -7, entry=entry)
    if k2.dwconv7x7.hopper_launches - before != 2 * (entry != "K2"):
        failed.append(f"{entry} dx {list(x.shape)} did not take the routed "
                      "kernel")


def time_k2(torch, x, w, b):
    """ms per launch of K2's Hopper kernel and of ``dwconv.cu`` on the same
    inputs (the route forced), in turns (Hopper, dwconv.cu, dwconv.cu,
    Hopper; the mean of each kernel's two medians), cuDNN's depthwise
    ``conv2d`` on a channels_last view, and the bound."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    C, n = x.shape[-1], x.numel()

    def tile():
        with swapped(old_route(k2)):
            return k2.dwconv7x7(x, w, b)

    hopper, tile = in_turns_ms(torch, lambda: k2.dwconv7x7(x, w, b), tile)
    w_cudnn = w.t().reshape(C, 1, 7, 7).contiguous()
    x_cl = x.permute(0, 3, 1, 2)  # channels_last view, no copy
    cudnn = median_ms(torch, lambda: F.conv2d(x_cl, w_cudnn, b, padding=3,
                                              groups=C))
    bound, by = bound_ms(2 * n * 2 + 50 * C * 2, 98 * n, F32_FLOPS)
    return {"hopper": hopper, "tile": tile, "cudnn": cudnn,
            "bound": bound}, by


def time_k2_wgrad(torch, x, gy):
    """ms per launch of K2 wgrad's Hopper kernel and of ``dwconv_wgrad.cu``
    on the same inputs (the route forced), in turns (Hopper, dwconv_wgrad.cu,
    dwconv_wgrad.cu, Hopper; the mean of each kernel's two medians), cuDNN's
    depthwise weight and bias gradient (``convolution_backward`` on
    channels_last views), and the bound: x and g read once, float32 dw
    written, 98 flops per element."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    C, n = x.shape[-1], x.numel()

    def tile():
        with swapped((k2, "wgrad_route", lambda dtype, C_: "tile")):
            return k2.dwconv7x7_wgrad(x, gy)

    hopper, tile = in_turns_ms(torch, lambda: k2.dwconv7x7_wgrad(x, gy),
                               tile)
    x_cl, gy_cl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    w_cudnn = torch.zeros(C, 1, 7, 7, dtype=x.dtype, device=x.device)
    cudnn = median_ms(torch, lambda: torch.ops.aten.convolution_backward(
        gy_cl, x_cl, w_cudnn, [C], [1, 1], [3, 3], [1, 1], False, [0, 0], C,
        [False, True, True]))
    bound, by = bound_ms(2 * n * 2 + 49 * C * 4, 98 * n, F32_FLOPS)
    return {"hopper": hopper, "tile": tile, "cudnn": cudnn,
            "bound": bound}, by


def compare_kernels(torch, dev):
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops.convnext_mlp import (
        convnext_mlp, convnext_mlp_plain)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    g = torch.Generator().manual_seed(1)
    rows, faults, failed = [], [], []
    inputs = {}
    record = recorder(rows, failed)
    k3.convnext_mlp.wgmma_launches = 0
    k3.convnext_mlp.wide_launches = 0

    mean, std = (0.45,) * 3, (0.225,) * 3
    u8 = torch.randint(0, 256, (N_FRAMES, *CONTENT, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = dequant_normalize_pad(u8, S, mean, std, out_dtype)
        ref = dequant_normalize_pad_plain(u8, S, mean, std, out_dtype)
        torch.cuda.synchronize()
        if got.dtype != out_dtype:
            raise SystemExit(f"K1 wrote {got.dtype}, asked for {out_dtype}")
        # the same float32 formula, product rounded before the sum, one
        # rounding to the output dtype: bit-equal
        name = "K1" if out_dtype == torch.bfloat16 else "K1 float32"
        record(name, [N_FRAMES, *CONTENT, 3], max_err(torch, got, ref), 0.0)
    inputs["K1"] = (u8, mean, std)
    # the scaled ViViT configuration's frames: 189 content rows (an odd
    # letterbox pad) into 336²
    u8v = torch.randint(0, 256, (256, *VIVIT_CONTENT, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(6)).to(dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = dequant_normalize_pad(u8v, VIVIT_S, mean, std, out_dtype)
        ref = dequant_normalize_pad_plain(u8v, VIVIT_S, mean, std, out_dtype)
        torch.cuda.synchronize()
        record(f"K1 into 336² {str(out_dtype)[6:]}", [256, *VIVIT_CONTENT, 3],
               max_err(torch, got, ref), 0.0, entry="K1")
    # side bars on every row and content rows of 639 bytes, which start off
    # the 16-byte boundary: the row kernel's narrow loads and its mixed
    # bar/content vectors
    u8s = torch.randint(0, 256, (64, *K1_SIDE_CONTENT, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(7)).to(dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = dequant_normalize_pad(u8s, S, mean, std, out_dtype)
        ref = dequant_normalize_pad_plain(u8s, S, mean, std, out_dtype)
        torch.cuda.synchronize()
        record(f"K1 side bars {str(out_dtype)[6:]}", [64, *K1_SIDE_CONTENT, 3],
               max_err(torch, got, ref), 0.0, entry="K1")
    del u8v, u8s, got, ref

    for H, C, _ in STAGES:
        x, w, b = k2_inputs(torch, dev, g, (N_FRAMES, H, H, C))
        check_k2(torch, x, w, b, record, faults, failed)
        # dwconv.cu on the same inputs (the route forced): it serves float32
        # and other widths, and is timed beside the Hopper kernel
        with swapped((k2, "route", lambda dtype, C_: "tile")):
            check_k2(torch, x, w, b, record, faults, failed)
        inputs[("K2", C)] = (x, w, b)

        xs = torch.randn(N_FRAMES, H, H, C, generator=g).to(dev, torch.bfloat16)
        p = k3_params(torch, C, g, dev)
        for approximate in (True, False):
            got = convnext_mlp(xs, x, approximate=approximate, **p)
            ref = convnext_mlp_plain(xs, x, approximate=approximate, **p)
            torch.cuda.synchronize()
            # bf16 roundings of t and h_pre can flip by 1 ulp where the
            # float32 sums differ in order; 2 ulps at the largest output.
            # Such flips are rare, so the mean error stays under 2^-12 of
            # the mean |output|, where a fault in every row would not.
            tol = float(ref.float().abs().max()) * 2 ** -6
            mean_tol = float(ref.float().abs().mean()) * 2 ** -12
            record(f"K3 approximate={approximate}", [N_FRAMES, H, H, C],
                   max_err(torch, got, ref), tol,
                   mean_err(torch, got, ref), mean_tol)
        # ref, tol and mean_tol are those of approximate=False
        for fault, change in K3_FAULTS.items():
            fp, fap = change(p, False)
            bad = convnext_mlp_plain(xs, x, approximate=fap, **fp)
            err, mean = max_err(torch, bad, ref), mean_err(torch, bad, ref)
            seen = err > tol or mean > mean_tol
            faults.append({"fault": fault, "shape": [N_FRAMES, H, H, C],
                           "max_abs_err": err, "mean_abs_err": mean,
                           "seen": seen})
            log(f"[compare] K3 with fault {fault} {[N_FRAMES, H, H, C]}: "
                f"max_abs_err {err:.3e}, mean_abs_err {mean:.3e}: "
                f"{'seen' if seen else 'NOT seen'}")
            if not seen:
                failed.append(f"K3 fault {fault} not seen at C={C}")
        inputs[("K3", C)] = (xs, x, p)

    # K2's Hopper kernel at the stage sizes of other frame sizes and odd
    # sides, forward and dx
    for shape in K2_ODD_SHAPES:
        x, w, b = k2_inputs(torch, dev, g, shape)
        check_k2(torch, x, w, b, record, faults, failed)
        gy = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        check_k2_dx(torch, x, w, b, gy, record, failed)
        del x, w, b, gy

    # The Hopper kernel (``convnext_mlp_wgmma.cu``) at every width it
    # takes and the split kernel (``convnext_mlp_wide.cu``) at its two,
    # eval and train, both GELU forms, at 100 rows (less than one block's)
    # and 2,000 (no multiple of any block's rows), with K3's faults; the
    # stage shapes above already went through the Hopper kernel. The split
    # kernel also at the last stage's 9,800 rows, twice, and stage by
    # stage.
    for C in k3.WGMMA_DIMS + k3.WIDE_DIMS:
        for M in (100, 2000):
            check_k3_small(torch, dev, g, C, M, record, faults, failed)
    for C in k3.WIDE_DIMS:
        check_k3_small(torch, dev, g, C, N_FRAMES * 7 * 7, record, faults,
                       failed)
        check_k3_wide(torch, dev, g, C, N_FRAMES * 7 * 7, record, failed)
        torch.cuda.empty_cache()
    # K3 on float32 activations takes the same Hopper kernel at the same
    # widths: each of them at 100 and 2,000 rows, the stage shapes being
    # phase 17's
    for C in k3.WGMMA_DIMS:
        for M in (100, 2000):
            check_k3_small(torch, dev, g, C, M, record, faults, failed,
                           torch.float32)
    k3_routed = (k3.convnext_mlp.wgmma_launches,
                 k3.convnext_mlp.wide_launches)
    # The other compiled variants, off the main paths, on the mma.sync
    # kernel (``convnext_mlp.cu``), the route forced: K3 in bf16 at 1024
    # and 1536 and on float32 at 96, 1024 and 1536 (the yardsticks phases
    # 17, 24 and 25 time beside the Hopper kernels; float32 at 1024 and
    # 1536 was its route before the split kernel took it). A row count
    # that is no multiple of any block's rows exercises the tail.
    rows_off = 2000
    with swapped((k3, "route", lambda dtype, C_: "mma")):
        for C in k3.WIDE_DIMS:
            check_k3_small(torch, dev, g, C, rows_off, record, faults, failed)
        for C in (96,) + k3.WIDE_DIMS:
            check_k3_small(torch, dev, g, C, rows_off, record, faults,
                           failed, torch.float32)
    # K2 on float32 on the Hopper kernel, bit-equal to dwconv.cu (the
    # route forced), at a frame of 56² (phase 17 holds the stage shapes)
    x = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    w = (torch.randn(49, 96, generator=g) / 7).to(dev)
    b = (torch.randn(96, generator=g) * 0.1).to(dev)
    gy = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    check_k2_f32(torch, x, w, b, gy, record, faults, failed)
    # the route by dtype and width: the four stage shapes (two GELU forms
    # each) and the small checks in bf16 and float32 took the Hopper
    # kernel; the split kernel's widths at three row counts (two forms
    # each) and twice more in ``check_k3_wide`` took the split kernel; the
    # rest neither
    want = (4 * 2 + len(k3.WGMMA_DIMS) * 2 * 2 * 2,
            len(k3.WIDE_DIMS) * (3 * 2 + 2))
    after = (k3.convnext_mlp.wgmma_launches, k3.convnext_mlp.wide_launches)
    log(f"[compare] K3 launches on the Hopper and split kernels {k3_routed} "
        f"(expected {want}), after the mma.sync checks {after}")
    if not k3_routed == want == after:
        failed.append("K3 took the wrong kernel")
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return {"rows": rows, "faults": faults, "inputs": inputs}


def compare_train_kernels(torch, dev, inputs):
    """The training path's kernels against their plain versions at the
    flagship shapes, on phase 2's K2 and K3 inputs (bf16): K2 wgrad on its
    Hopper kernel and on ``dwconv_wgrad.cu`` (the route forced), each
    bit-equal over two runs, K2 dx (the forward kernel on flipped taps,
    through the autograd Function, against autograd through the plain
    conv) and K3 train (out bit-equal to the eval kernel; t, h_pre, m held
    by K3's rule). Faulty plain versions must land outside each tolerance.
    Then the Hopper wgrad kernel at the odd shapes and on float32 inputs
    (``f32_train_kernels`` holds its float32 route at the stage
    shapes)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    g = torch.Generator().manual_seed(5)
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    for H, C, _ in STAGES:
        shape = [N_FRAMES, H, H, C]
        x, w, b = inputs[("K2", C)]
        gy = torch.randn(N_FRAMES, H, H, C, generator=g).to(dev, torch.bfloat16)
        check_k2_wgrad(torch, x, gy, record, failed, faults)
        # dwconv_wgrad.cu on the same inputs (the route forced): it serves
        # float32 and other widths, and is timed beside the Hopper kernel
        with swapped((k2, "wgrad_route", lambda dtype, C_: "tile")):
            check_k2_wgrad(torch, x, gy, record, failed)
        inputs[("K2 wgrad", C)] = (x, gy)

        # dx: the Function's backward against autograd through F.conv2d
        check_k2_dx(torch, x, w, b, gy, record, failed)

        xs, y, p = inputs[("K3", C)]
        with torch.no_grad():
            out_eval = k3.convnext_mlp(xs, y, approximate=True, **p)
        out, t, h_pre, m = k3.convnext_mlp_train(xs, y, approximate=True, **p)
        ref = dict(zip(("out", "t", "h_pre", "m"), k3.convnext_mlp_train_plain(
            xs, y, approximate=True, **p)))
        torch.cuda.synchronize()
        # the same tile computes out in both variants
        record("K3 train out vs eval (bit-equal)", shape,
               max_err(torch, out, out_eval), 0.0, entry="K3 train")
        tols = {}
        for name, v in (("t", t), ("h_pre", h_pre), ("m", m)):
            r = ref[name]
            # K3's rule: rare 1-ulp flips of bf16 values, 2 ulps at the
            # largest, and a mean error under 2^-12 of the mean |value|
            tols[name] = (float(r.float().abs().max()) * 2 ** -6,
                          float(r.float().abs().mean()) * 2 ** -12)
            record(f"K3 train {name}", [N_FRAMES * H * H, v.shape[-1]],
                   max_err(torch, v, r), tols[name][0],
                   mean_err(torch, v, r), tols[name][1], entry="K3 train")
        # the backward's GELU and GELU′ lookups against the formulas
        h_tab, grad_tab = k3._gelu_tables(h_pre.device, True)
        idx = h_pre.view(torch.int16).int()
        hf = h_pre.float()
        record("K3 bwd GELU lookup (bit-equal)", [N_FRAMES * H * H, 4 * C],
               max(max_err(torch, h_tab[idx],
                           k3.gelu_f32(hf, True).to(torch.bfloat16)),
                   max_err(torch, grad_tab[idx], k3.gelu_grad_f32(hf, True))),
               0.0, entry="K3 train")
        del idx, hf
        bad = {"m saved without b2": ("m", m, (ref["m"].float() - p["b2"]).to(
                   torch.bfloat16)),
               "h_pre saved after GELU": ("h_pre", h_pre, k3.gelu_f32(
                   ref["h_pre"].float(), True).to(torch.bfloat16))}
        for fault, (name, v, wrong) in bad.items():
            err, mean = max_err(torch, v, wrong), mean_err(torch, v, wrong)
            fault_seen(faults, failed, f"K3 train {fault}", shape,
                       err > tols[name][0] or mean > tols[name][1],
                       max_abs_err=err, mean_abs_err=mean)
    # the Hopper wgrad kernel at the odd shapes, and on float32 inputs
    for shape in K2_ODD_SHAPES:
        x, _, _ = k2_inputs(torch, dev, g, shape)
        gy = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        check_k2_wgrad(torch, x, gy, record, failed)
    x = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    gy = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    check_k2_wgrad(torch, x, gy, record, failed)
    del x, gy
    if failed:
        raise SystemExit(f"training kernel disagrees with its plain version: "
                         f"{failed}")
    return {"rows": rows, "faults": faults}


def k2_wgrad_entry(torch, x):
    """The kernels-line entry of the wgrad kernel ``dwconv.wgrad_route``
    picks (its Hopper kernel's float32 route has one of its own)."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    if k2.wgrad_route(x.dtype, x.shape[-1]) != "hopper":
        return "K2 wgrad"
    return ("K2 wgrad (hopper f32)" if x.dtype == torch.float32
            else "K2 wgrad (hopper)")


def check_k2_wgrad(torch, x, gy, record, failed, faults=None):
    """K2's weight gradient on the kernel of ``dwconv.wgrad_route`` against
    its plain version, relative to Σ|x·g| per tap and channel, and bit-equal
    over two runs; both launches must count on the routed kernel. With
    ``faults``, the plain result with its taps flipped, and with dy and dx
    swapped, must land outside."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    shape, C = list(x.shape), x.shape[-1]
    entry = k2_wgrad_entry(torch, x)
    tag = entry + (" float32" if entry == "K2 wgrad"
                   and x.dtype == torch.float32 else "")
    before = k2.dwconv7x7_wgrad.hopper_launches
    got = k2.dwconv7x7_wgrad(x, gy)
    again = k2.dwconv7x7_wgrad(x, gy)
    ref = k2.dwconv7x7_wgrad_plain(x, gy)
    # Σ|x·g| per tap and channel: the scale of a float32 sum's rounding
    scale = k2.dwconv7x7_wgrad_plain(x.abs(), gy.abs()).clamp_min(1e-30)
    torch.cuda.synchronize()

    def rel(a):
        return float(((a - ref).abs() / scale).max())

    # float32 sums of up to 627,200 products in another order: each partial
    # sum rounds at 2^-24 of its size, far under 1e-6 of Σ|x·g|, while a
    # wrong tap order is off by ~1/√(N·H·W) of it (≥ 1e-3 at the stages)
    record(f"{tag} (err / Σ|x·g|)", shape, rel(got), WGRAD_TOL,
           abs_err=max_err(torch, got, ref), entry=entry)
    record(f"{tag} twice (bit-equal)", shape, max_err(torch, got, again), 0.0,
           entry=entry)
    if faults is not None:
        taps = ref.view(7, 7, C)
        for name, bad in (("taps flipped", taps.flip(0, 1)),
                          ("dy and dx swapped", taps.transpose(0, 1))):
            err = rel(bad.reshape(49, C))
            fault_seen(faults, failed, f"{tag} {name}", shape,
                       err > WGRAD_TOL, err=err)
    if k2.dwconv7x7_wgrad.hopper_launches - before != 2 * (entry != "K2 wgrad"):
        failed.append(f"{tag} {shape} did not take the routed kernel")


# ---- 2c. K4 against its plain version ------------------------------------

# (B, S, H, D, dtype name): the scaled configuration's shape, its shape under
# phase 21's tensor parallelism (3 of the 6 heads a rank), the kernel A/B
# shape of the JAX package's record, 448² frames, vivit_base's heads, ragged
# tiles (S no multiple of 64), a sequence shorter than a tile, head_dim 16
# (vivit_tiny) and float32 inputs; then the lengths on the edges of the
# backward kernels' tiles (64 rows a warpgroup, 128 keys a dK/dV block, 192
# queries a dQ block) and one past 1,024; then the float32 kernels (split
# products, the same tiles) at the scaled shape and the same edges; then
# head_dim 16 (FLASH_D16_SHAPES).
FLASH_MAIN = (256, 576, 6, 64, "bfloat16")
FLASH_TP = (256, 576, 3, 64, "bfloat16")
FLASH_MAIN_F32 = (256, 576, 6, 64, "float32")
# head_dim 16 at vivit_tiny's shape (8 clips of 32 frames of 224², 256
# tokens, 4 heads of 16; 2 spatial blocks) in bf16 and float32, then the
# lengths on the edges of its kernels' tiles (64 rows a warpgroup and a
# backward ring tile, 128 rows an item and a forward key tile, two key
# tiles a forward step) and a length of 4, in both dtypes
FLASH_D16 = ((256, 256, 4, 16, "bfloat16"), (256, 256, 4, 16, "float32"))
FLASH_D16_SHAPES = FLASH_D16 + tuple(
    (B, S, H, 16, dtype) for dtype in ("bfloat16", "float32")
    for B, S, H in ((3, 1, 2), (3, 4, 4), (2, 63, 2), (2, 65, 2), (2, 127, 2),
                    (2, 129, 2), (2, 255, 2), (2, 257, 3), (2, 385, 2),
                    (4, 200, 4)))
FLASH_F32_SHAPES = (
    FLASH_MAIN_F32,
    (3, 1, 2, 64, "float32"),
    (2, 63, 2, 64, "float32"),
    (2, 65, 2, 64, "float32"),
    (2, 127, 2, 64, "float32"),
    (2, 129, 2, 64, "float32"),
    (2, 193, 3, 64, "float32"),
    (4, 577, 6, 64, "float32"),
    (2, 1030, 2, 64, "float32"),
)
# where the faulty plain versions are held against the kernels
FLASH_FAULT_SHAPES = (FLASH_MAIN, FLASH_TP, (4, 200, 6, 64, "bfloat16"),
                      FLASH_MAIN_F32, (4, 577, 6, 64, "float32")) + FLASH_D16
FLASH_SHAPES = (
    FLASH_MAIN,
    FLASH_TP,
    (64, 576, 6, 64, "bfloat16"),
    (16, 1024, 6, 64, "bfloat16"),
    (8, 576, 12, 64, "bfloat16"),
    (4, 577, 6, 64, "bfloat16"),
    (4, 200, 6, 64, "bfloat16"),
    (2, 130, 6, 64, "float32"),
    (3, 1, 2, 64, "bfloat16"),
    (2, 63, 2, 64, "bfloat16"),
    (2, 65, 2, 64, "bfloat16"),
    (2, 127, 2, 64, "bfloat16"),
    (2, 129, 2, 64, "bfloat16"),
    (2, 193, 3, 64, "bfloat16"),
    (2, 1030, 2, 64, "bfloat16"),
) + FLASH_F32_SHAPES + FLASH_D16_SHAPES


def flash_entry(kind, dtype, D):
    """The kernels-line entry of K4's ``kind`` ("fwd", "bwd dKdV", "bwd
    dQ", "split": float32 only) at a dtype name and head_dim: each route is
    an entry of its own, bf16 with head_dim 64 the plain name, float32 with
    head_dim 64 " (f32)", head_dim 16 " (d16)" and " (d16 f32)"; the split
    pass "K4 split" and, at head_dim 16, "K4 split (d16)"."""
    if kind == "split":
        return "K4 split" if D == 64 else "K4 split (d16)"
    tag = {("bfloat16", 64): "", ("float32", 64): " (f32)",
           ("bfloat16", 16): " (d16)", ("float32", 16): " (d16 f32)"}
    return f"K4 {kind}{tag[(dtype, D)]}"


def hi_only_fwd(torch, fa, q, k, v, scale):
    """The split fault of K4's float32 forward: every product's operands
    (q, k, p, v) rounded to bf16 once, as one bf16 pass would take them
    (only hi · hi), float32 sums and output."""
    qf, kf, vf = (fa._heads_first(t.to(torch.bfloat16)) for t in (q, k, v))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, -1)
    o = torch.matmul(p.to(torch.bfloat16).float(), vf)
    return fa._tokens_first(o, torch.float32)


def hi_only_bwd(torch, fa, q, k, v, do, lse, di, scale):
    """The same fault in K4's float32 backward: (dq, dk, dv) from q, k, v,
    do, p and ds rounded to bf16 (``_bwd_p_ds`` rounds p and ds to the
    inputs' dtype), float32 sums and outputs."""
    b = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    p, ds = fa._bwd_p_ds(*b, lse, di, scale)
    qf, kf, dof = (fa._heads_first(t) for t in (b[0], b[1], b[3]))
    return tuple(fa._tokens_first(t, torch.float32) for t in (
        torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
        torch.matmul(p.transpose(-1, -2), dof)))


def flash_inputs(torch, shape, dev, g):
    B, S, H, D, dtype = shape
    dt = getattr(torch, dtype)
    return [torch.randn(B, S, H, D, generator=g).to(dev, dt) for _ in range(4)]


def flash_tols(torch, ref, dtype):
    """(largest, mean) error allowed against ``ref``. bf16: the kernel and
    the plain version share every rounding but that of p, which the kernel
    rounds as exp(s − running max) and the plain version as exp(s − lse):
    another scale, so each weight's 2^-9 relative rounding error is another
    one. Over a row these errors add up like the output itself (a sum of
    weights times values of either sign), to about 2^-9·|o| before o's own
    rounding, where half an ulp is 2^-9·|o| too. So: 2 ulps at the largest
    value and a mean under 2^-8 of the mean |value|, where a fault in every
    row is not. The backward recomputes p at the plain version's scale and
    only flips where sums differ in order. float32: sums of up to S·D
    products in another order and exp/log of other libraries, 2^-14 of the
    largest value."""
    big = float(ref.float().abs().max())
    if dtype == "float32":
        return big * 2 ** -14, big * 2 ** -14
    return big * 2 ** -6, float(ref.float().abs().mean()) * 2 ** -8


def compare_flash_kernels(torch, dev, shapes=FLASH_SHAPES):
    """K4's kernels against ``flash_mha_plain``, its two plain backward
    versions and ``_row_dot`` at ``shapes``: o and the log-sum-exp, di on
    the kernel's o, then dq, dk, dv on the kernel's own o, lse and di (so
    the backward is held alone), the backward bit-equal over two runs, the
    autograd Function equal to the direct calls, each call on its route's
    kernel (the counters), strided views read without a copy. On the
    float32 route also the split pass (``K4 split``) bit-equal to its plain
    version, a backward kernel on split copies made beforehand bit-equal to
    one that makes its own, and one split pass a forward and one a
    backward through the autograd Function. Faulty plain versions must
    land outside the tolerances; on float32 also the split fault
    (``hi_only_fwd``, ``hi_only_bwd``)."""
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(11)
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    inputs = {}

    def held(name, shape, got, ref, dtype, entry, floor=0.0):
        tol, mean_tol = (max(t, floor) for t in flash_tols(torch, ref, dtype))
        record(name, shape, max_err(torch, got, ref), tol,
               mean_err(torch, got, ref), mean_tol, entry=entry)
        return tol, mean_tol

    def di_held(name, shape, o, do):
        """The row kernel against ``_row_dot``: float32 sums of D products
        taken in another order, so 2^-20 of the largest Σ|o·do| of a row;
        then bit-equal over two runs. → (di, its tolerance)."""
        di = fa.flash_mha_bwd_di(o, do)
        tol = float((o.float() * do.float()).abs().sum(-1).max()) * 2 ** -20
        record(f"K4 bwd di{name}", shape,
               max_err(torch, di, fa._row_dot(o, do)), tol,
               entry="K4 bwd di")
        record(f"K4 bwd di{name} twice (bit-equal)", shape,
               max_err(torch, di, fa.flash_mha_bwd_di(o, do)), 0.0,
               entry="K4 bwd di")
        return di, tol

    def outside(got, ref, tols):
        return (max_err(torch, got, ref) > tols[0]
                or mean_err(torch, got, ref) > tols[1])

    def bwd_plain(*args):
        return (fa.flash_mha_bwd_dq_plain(*args),
                *fa.flash_mha_bwd_dkv_plain(*args))

    counts = [c for _, c in fa._ROUTES.values() if c]

    def routed(fn, route):
        """``fn``'s launches since its counters were zeroed all took the
        Hopper kernel of ``route``."""
        mine = fa._ROUTES[route][1]
        return all(getattr(fn, c) == fn.launches * (c == mine)
                   for c in counts)

    for shape in shapes:
        B, S, H, D, dtype = shape
        lst = list(shape)
        scale = D ** -0.5
        e_fwd, e_dkv, e_dq = (flash_entry(kind, dtype, D)
                              for kind in ("fwd", "bwd dKdV", "bwd dQ"))
        route = fa.route(getattr(torch, dtype), D)
        split_route = route in fa._SPLIT_ROUTES
        q, k, v, do = flash_inputs(torch, shape, dev, g)
        for fn in (fa.flash_mha, fa.flash_mha_bwd_dkv, fa.flash_mha_bwd_dq):
            fn.launches = 0
            for c in counts:
                setattr(fn, c, 0)
        fa.flash_mha_split.launches = 0
        o, lse = fa.flash_mha_fwd(q, k, v, scale)
        o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, scale)
        torch.cuda.synchronize()
        # bf16 and float32 at both head dims on their route's Hopper kernel
        # (float32 after one split pass)
        if (not routed(fa.flash_mha, route)
                or fa.flash_mha_split.launches != split_route):
            failed.append(f"K4 fwd took the wrong kernel at {lst}")
        tol_o = held("K4 fwd o", lst, o, o_ref, dtype, e_fwd)
        # float32 exp and log of another library on sums in another order
        record("K4 fwd lse", lst, max_err(torch, lse, lse_ref), 1e-4,
               entry=e_fwd)
        with torch.no_grad():
            o_nolse = fa.flash_mha(q, k, v, scale)
        record("K4 fwd without lse (bit-equal)", lst,
               max_err(torch, o_nolse, o), 0.0, entry=e_fwd)

        di, tol_di = di_held("", lst, o, do)
        splits = fa.flash_mha_split.launches
        # each makes its own split copies, called alone
        dk, dv = fa.flash_mha_bwd_dkv(q, k, v, do, lse, di, scale)
        dq = fa.flash_mha_bwd_dq(q, k, v, do, lse, di, scale)
        dq_ref, dk_ref, dv_ref = bwd_plain(q, k, v, do, lse, di, scale)
        torch.cuda.synchronize()
        if not (routed(fa.flash_mha_bwd_dkv, route)
                and routed(fa.flash_mha_bwd_dq, route)
                and fa.flash_mha_split.launches - splits == 2 * split_route):
            failed.append(f"K4 bwd took the wrong kernels at {lst}")
        # With one key the softmax has one weight and dq and dk are 0 in
        # exact arithmetic: both versions return the float32 rounding noise
        # of do·v − di times the scale, which is held to 2^-20 of the largest
        # Σ|do·v| where a share of a reference that is 0 would hold nothing.
        floor = 0.0 if S > 1 else scale * 2 ** -20 * float(
            (do.float() * v.float()).abs().sum(-1).max())
        tol_dq = held("K4 bwd dq", lst, dq, dq_ref, dtype, e_dq, floor)
        tol_dk = held("K4 bwd dk", lst, dk, dk_ref, dtype, e_dkv, floor)
        tol_dv = held("K4 bwd dv", lst, dv, dv_ref, dtype, e_dkv)
        dk2, dv2 = fa.flash_mha_bwd_dkv(q, k, v, do, lse, di, scale)
        dq2 = fa.flash_mha_bwd_dq(q, k, v, do, lse, di, scale)
        record("K4 bwd twice (bit-equal)", lst,
               max(max_err(torch, a, b) for a, b in
                   ((dq, dq2), (dk, dk2), (dv, dv2))), 0.0, entry=e_dkv)
        # the autograd Function runs the same four launches (on float32
        # with one split pass a direction: the backward's shared by dK/dV
        # and dQ)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        splits = fa.flash_mha_split.launches
        grads = torch.autograd.grad(fa.flash_mha(*leaves, scale), leaves, do)
        record("K4 through autograd (bit-equal)", lst,
               max(max_err(torch, a, b) for a, b in
                   zip(grads, (dq, dk, dv))), 0.0, entry=e_dq)
        if fa.flash_mha_split.launches - splits != 2 * split_route:
            failed.append(f"K4 through autograd split "
                          f"{fa.flash_mha_split.launches - splits} times "
                          f"at {lst}")
        del leaves, grads, dk2, dv2, dq2, o_nolse
        if split_route:
            # the split pass against its plain version, the forward's form
            # and the backward's, then both backward kernels on the
            # backward's copies made beforehand
            for ops in ((q, k, v), (q, k, v, do)):
                split = fa.flash_mha_split(*ops)
                record(f"K4 split of {len(ops)} operands (bit-equal)", lst,
                       max_err(torch, split, fa.flash_mha_split_plain(*ops)),
                       0.0, entry=flash_entry("split", dtype, D))
            dk2, dv2 = fa.flash_mha_bwd_dkv(q, k, v, do, lse, di, scale,
                                            split=split)
            dq2 = fa.flash_mha_bwd_dq(q, k, v, do, lse, di, scale,
                                      split=split)
            record("K4 bwd on split copies made beforehand (bit-equal)", lst,
                   max(max_err(torch, a, b) for a, b in
                       ((dq, dq2), (dk, dk2), (dv, dv2))), 0.0, entry=e_dkv)
            del split, dk2, dv2, dq2

        if dtype == "float32" and shape in FLASH_FAULT_SHAPES:
            # the split fault: only hi · hi of every product, as one bf16
            # pass takes them
            wrong = hi_only_fwd(torch, fa, q, k, v, scale)
            fault_seen(faults, failed, "K4 fwd products of hi halves only",
                       lst, outside(o, wrong, tol_o),
                       max_abs_err=max_err(torch, o, wrong),
                       mean_abs_err=mean_err(torch, o, wrong))
            wrong = hi_only_bwd(torch, fa, q, k, v, do, lse, di, scale)
            for name, got, bad_, tols in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                             wrong, (tol_dq, tol_dk, tol_dv)):
                fault_seen(faults, failed, f"K4 bwd products of hi halves "
                           f"only ({name})", lst, outside(got, bad_, tols),
                           max_abs_err=max_err(torch, got, bad_),
                           mean_abs_err=mean_err(torch, got, bad_))
            del wrong
        if shape in FLASH_FAULT_SHAPES:
            # faults in the forward's plain version
            bad = {"sm_scale dropped": fa.flash_mha_plain(q, k, v, 1.0)}
            p = torch.exp(torch.matmul(
                fa._heads_first(q), fa._heads_first(k).transpose(-1, -2))
                * scale - lse_ref[..., None])
            last = p[..., (S - 1) // 64 * 64:].sum(-1)  # the last key tile
            bad["last key tile out of the normaliser"] = (
                o_ref.float() / (1 - last).permute(0, 2, 1)[..., None])
            del p, last
            if S % 64:
                pad = (0, 0, 0, 0, 0, -S % 64)
                bad["keys past S attended"] = fa.flash_mha_plain(
                    *(torch.nn.functional.pad(t, pad) for t in (q, k, v)),
                    scale)[:, :S]
            for name, wrong in bad.items():
                fault_seen(faults, failed, f"K4 fwd {name}", lst,
                           outside(o, wrong, tol_o),
                           max_abs_err=max_err(torch, o, wrong),
                           mean_abs_err=mean_err(torch, o, wrong))
            del bad
            # faults in the backward's plain version
            no_di = bwd_plain(q, k, v, do, lse, torch.zeros_like(di), scale)
            no_scale = bwd_plain(q, k, v, do, lse, di, 1.0)
            for name, got, wrong, tols in (
                    ("di left out of ds (dq)", dq, no_di[0], tol_dq),
                    ("di left out of ds (dk)", dk, no_di[1], tol_dk),
                    ("ds not scaled (dq)", dq, no_scale[0], tol_dq),
                    ("p recomputed without sm_scale (dv)", dv, no_scale[2],
                     tol_dv)):
                fault_seen(faults, failed, f"K4 bwd {name}", lst,
                           outside(got, wrong, tols),
                           max_abs_err=max_err(torch, got, wrong),
                           mean_abs_err=mean_err(torch, got, wrong))
            del no_di, no_scale
            # a fault in di's plain version: the last 8 columns left out
            short = fa._row_dot(o[..., :-8], do[..., :-8])
            fault_seen(faults, failed, "K4 bwd di without do's last 8 "
                       "columns", lst, max_err(torch, di, short) > tol_di,
                       max_abs_err=max_err(torch, di, short))
            del short
        if shape == FLASH_MAIN:
            inputs["K4"] = (q, k, v, do, o, lse, di)
        if shape == FLASH_MAIN_F32:
            inputs["K4 f32"] = (q, k, v, do, o, lse, di)
        del q, k, v, do, o, lse, di, o_ref, lse_ref, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()

    # q, k, v as slices of one fused projection and a transposed gradient:
    # read through their strides, no copy, by each route
    B, S = 4, 200
    for D, dtype in sorted({shape[3:] for shape in shapes}):
        H = 6 if D == 64 else 4
        lst, dt = [B, S, H, D, dtype], getattr(torch, dtype)
        qkv = torch.randn(B, S, 3, H, D, generator=g).to(dev, dt)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, H, S, D, generator=g).to(dev, dt).permute(
            0, 2, 1, 3)
        fa.flash_mha.copies = 0
        o, lse = fa.flash_mha_fwd(q, k, v, D ** -0.5)
        # di on o as a transposed view too (the saved o is contiguous in the
        # model; do is the view that arrives in training)
        o_view = o.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        di, _ = di_held(" on strided views", lst, o_view, do)
        record("K4 bwd di strided views vs contiguous (bit-equal)", lst,
               max_err(torch, di, fa.flash_mha_bwd_di(o, do.contiguous())),
               0.0, entry="K4 bwd di")
        dk, dv = fa.flash_mha_bwd_dkv(q, k, v, do, lse, di, D ** -0.5)
        dq = fa.flash_mha_bwd_dq(q, k, v, do, lse, di, D ** -0.5)
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        o_c, lse_c = fa.flash_mha_fwd(qc, kc, vc, D ** -0.5)
        dk_c, dv_c = fa.flash_mha_bwd_dkv(qc, kc, vc, doc, lse_c, di,
                                          D ** -0.5)
        dq_c = fa.flash_mha_bwd_dq(qc, kc, vc, doc, lse_c, di, D ** -0.5)
        torch.cuda.synchronize()
        record("K4 strided views vs contiguous (bit-equal)", lst,
               max(max_err(torch, a, b) for a, b in
                   ((o, o_c), (dq, dq_c), (dk, dk_c), (dv, dv_c))), 0.0,
               entry=flash_entry("fwd", dtype, D))
        if fa.flash_mha.copies:
            failed.append(f"strided {dtype} views were copied "
                          f"{fa.flash_mha.copies} times")
        del qkv, q, k, v, do, o, lse, di, o_view, qc, kc, vc, doc
    # what the kernels do not take raises on the card
    for bad_q in (torch.randn(2, 8, 2, 32, device=dev, dtype=torch.bfloat16),
                  torch.randn(2, 8, 2, 64, device=dev, dtype=torch.float16)):
        try:
            fa.flash_mha(bad_q, bad_q, bad_q, 1.0)
        except ValueError as e:
            log(f"[compare] K4 refuses {tuple(bad_q.shape)} {bad_q.dtype}: {e}")
        else:
            failed.append(f"K4 took {tuple(bad_q.shape)} {bad_q.dtype}")
        try:
            fa.flash_mha_bwd_di(bad_q, bad_q)
        except ValueError:
            pass
        else:
            failed.append(f"K4 bwd di took {tuple(bad_q.shape)} {bad_q.dtype}")
    if failed:
        raise SystemExit(f"K4 disagrees with its plain version: {failed}")
    return {"rows": rows, "faults": faults, "inputs": inputs}


# ---- 3. serving forward ------------------------------------------------

def redraw_weights(torch, model, g):
    """Every bias and norm redrawn from ``g``, as the CPU tests do, so that
    a kernel that dropped one would show: biases N(0, 0.1²), LayerNorm and
    BatchNorm scales 1 + N(0, 0.1²), BatchNorm running means N(0, 0.1²)
    and variances in [0.5, 1.5]; ConvNeXt layer-scale γ of order 1 (the
    init 1e-6 makes each block an identity); ``fc_out`` scaled by
    LOGIT_SCALE so the probabilities are far from uniform."""
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.models.norm import BatchNorm

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, BatchNorm)):
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(
                    torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.num_features, generator=g) + 0.5)
            if isinstance(m, convnext.ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.dim, generator=g) + 0.5)
        model.fc_out.weight.mul_(LOGIT_SCALE)


def block_launches(torch, model):
    """(ConvNeXt blocks in ``model``, of them on K3, of those on K3's split
    kernel) by each block's switch and compute dtype: one K2 launch a block
    in a forward, one K3 launch a block that takes K3."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.models.backbones import convnext

    blocks = [m for m in model.modules()
              if isinstance(m, convnext.ConvNeXtBlock)]
    fused = [m for m in blocks if m.use_fused_mlp]
    return len(blocks), len(fused), sum(
        k3.route(m.dtype, m.dim) == "wide" for m in fused)


def serving_forward(torch, dev, size=S, content=CONTENT, tag="serve",
                    power=True, cfg=None, model=None, logit_spread=False):
    """The flagship's serving forward at ``size``² frames of ``content``
    letterbox rows and columns, against the same forward on plain versions;
    ``power``: the faults that must land outside the tolerance. ``cfg``
    (default ``ExperimentConfig()``) and ``model`` (default: the
    predictor's seeded one) serve another configuration; its weights are
    redrawn here. ``logit_spread``: ``fc_out`` rescaled so that the
    clips' logits spread about 0 (``spread_logits``), for a model whose
    clips' probabilities would otherwise sit together near one class."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.ops import (
        convnext_mlp, dequant_pad, dwconv, preprocess)

    cfg = cfg or ExperimentConfig()
    if size != S:
        cfg = cfg.override({"data.frame_size": size})
    # seeded weights, on the card
    pred = CollisionPredictor(cfg, None, model_override=model)
    g = torch.Generator().manual_seed(2)
    redraw_weights(torch, pred.model, g)
    T = cfg.data.num_frames // pred._fold_stride()
    # noise of another level and contrast in each clip, so the clips differ
    frames = torch.stack([
        torch.randint(12 * i, 256 - 16 * i, (T, *content, 3), generator=g,
                      dtype=torch.uint8) for i in range(8)])
    forward = pred._make_forward(folded_stride=True)
    frames_dev = frames.to(dev)
    if logit_spread:
        module = pred.serving_module(True)
        with torch.no_grad():
            x = preprocess.eval_preprocess(frames_dev, module.augment,
                                           module.frame_size, module.dtype,
                                           use_kernel="force")
        a = spread_logits(torch, module.model, pred.model.fc_out, x)
        log(f"[{tag}] fc_out rescaled by {a:.3f}")
        del x
    torch.cuda.synchronize()

    counters = zero_counters()
    probs = forward(frames_dev)
    torch.cuda.synchronize()
    log(f"[{tag}] probs {probs.tolist()}")
    blocks, fused, on_wide = block_launches(torch, pred.model)
    launches = expect_launches(tag, counters,
                               f32=cfg.model.dtype == "float32",
                               wide={"K3": on_wide}, K1=1, K2=blocks,
                               K3=fused)
    if tuple(probs.shape) != (8, 3) or not bool(torch.isfinite(probs).all()):
        raise SystemExit(f"bad probabilities {probs}")
    row_err = float((probs.sum(-1) - 1).abs().max())
    if row_err > 1e-5:
        raise SystemExit(f"probability rows do not sum to 1 ({row_err})")

    spread = {"min": float(probs.min()), "max": float(probs.max()),
              "across_clips": float((probs.max(0).values
                                     - probs.min(0).values).max())}
    log(f"[{tag}] probabilities span {spread['min']:.4f}..{spread['max']:.4f}; "
        f"largest spread of one class across clips {spread['across_clips']:.4f}")
    if spread["across_clips"] < SPREAD_MIN:
        raise SystemExit(f"probabilities too alike to test with ({spread})")

    def plain_forward(mlp=convnext_mlp.convnext_mlp_plain,
                      dw=dwconv.dwconv7x7_plain):
        """The same forward with every kernel swapped for its plain version
        (``mlp`` in place of K3, ``dw`` in place of K2)."""
        with swapped((convnext, "dwconv7x7", dw),
                     (convnext, "convnext_mlp", mlp),
                     (preprocess, "dequant_normalize_pad",
                      dequant_pad.dequant_normalize_pad_plain)):
            out = pred._make_forward(True)(frames_dev)
            torch.cuda.synchronize()
        return out

    err = max_err(torch, probs, plain_forward())
    tol = SPREAD_SERVE_TOL if logit_spread else SERVE_TOL
    log(f"[{tag}] kernels vs plain: max |Δprob| {err:.3e} (tol {tol:.0e})")
    summary = {"frame_size": size, "launches": launches,
               "probs": probs.tolist(), "max_abs_err_vs_plain": err,
               "tol": tol, "spread": spread, "row_sum_err": row_err}
    if not power:
        if not err <= tol:
            raise SystemExit(f"{tag}: forward disagrees with its plain "
                             "version")
        return {"pred": pred, "forward": forward, "frames": frames_dev,
                "summary": summary}

    # The check's power: the plain forward with one fault in every block.
    # A dropped bias must land outside the tolerance; the smaller faults
    # are reported (phase 2's mean error sees them).
    def k3_with(change):
        def mlp(x, y, *args):
            p, ap = change(dict(zip(K3_ARGS, args[:7])), args[7])
            return convnext_mlp.convnext_mlp_plain(x, y, approximate=ap, **p)
        return mlp

    seen = {name: max_err(torch, probs, plain_forward(mlp=k3_with(change)))
            for name, change in K3_FAULTS.items()}
    seen["dwconv_bias_dropped"] = max_err(torch, probs, plain_forward(
        dw=lambda x, w, b: dwconv.dwconv7x7_plain(x, w, b * 0)))
    required = ("b2_dropped", "dwconv_bias_dropped")
    for name, v in seen.items():
        log(f"[{tag}] with fault {name}: max |Δprob| {v:.3e} "
            f"({'must exceed' if name in required else 'beside'} tol "
            f"{tol:.0e})")
    if not err <= tol:
        raise SystemExit(f"{tag}: forward disagrees with its plain version")
    if not all(seen[name] > tol for name in required):
        raise SystemExit(f"the tolerance does not see a dropped bias: {seen}")
    return {"pred": pred, "forward": forward, "frames": frames_dev,
            "summary": dict(summary, faults_max_abs_err=seen)}


# ---- 3b. training step -------------------------------------------------

def kernel_counters():
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dequant_pad
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa
    from vision_collision_detection_tpu_torch.ops import fused_preprocess

    return {"K1": dequant_pad.dequant_normalize_pad, "K2": k2.dwconv7x7,
            "K2 wgrad": k2.dwconv7x7_wgrad, "K3": k3.convnext_mlp,
            "K3 train": k3.convnext_mlp_train, "K4 fwd": fa.flash_mha,
            "K4 bwd dKdV": fa.flash_mha_bwd_dkv,
            "K4 bwd dQ": fa.flash_mha_bwd_dq,
            "K4 bwd di": fa.flash_mha_bwd_di,
            "K4 split": fa.flash_mha_split,
            "train preprocess": fused_preprocess.fused_train_preprocess}


def zero_counters():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
        for name in HOPPER_COUNTS:
            if hasattr(fn, name):
                setattr(fn, name, 0)
    return counters


# A wrapper with two or three kernels counts the launches of its Hopper
# ones under these names beside ``launches`` (K3's split kernel under
# ``wide_launches``, K4's float32 kernels under ``f32_launches``, its
# head_dim-16 kernels under ``d16_launches`` and ``d16_f32_launches``).
HOPPER_COUNTS = ("wgmma_launches", "hopper_launches", "wide_launches",
                 "f32_launches", "d16_launches", "d16_f32_launches")


def expect_launches(tag, counters, f32=False, wide=None, **expected):
    """Every counter must read what ``expected`` says, 0 where it is silent;
    and where a wrapper has several kernels (K2, K2 wgrad, K3, K3 train, K4
    fwd), every launch must have taken a Hopper one; ``wide`` maps K3's
    counters to the launches expected on its split kernel (ConvNeXt base's
    and large's last stage), 0 where it is silent. Returns the launches by
    kernels-line entry: K2's split into ``K2`` (``dwconv.cu``) and ``K2
    (hopper)``, K2 wgrad's into ``K2 wgrad`` (``dwconv_wgrad.cu``) and
    ``K2 wgrad (hopper)``, K3's into ``K3`` (``convnext_mlp_wgmma.cu``),
    ``K3 (wide)`` (``convnext_mlp_wide.cu``) and ``K3 (mma.sync)``
    (``convnext_mlp.cu``), K3 train's likewise; with ``f32`` (a float32
    path) the Hopper launches of K2, K2 wgrad and K3 count as ``K2 (hopper
    f32)``, ``K2 wgrad (hopper f32)``, ``K3 (wgmma f32)``, ``K3 train
    (wgmma f32)``, ``K3 (wide f32)`` and ``K3 train (wide f32)``, and
    ``convnext_mlp.cu``'s as ``K3 (f32)``. K4's forward, dK/dV and dQ (each
    with a Hopper kernel for bf16 and one for float32, on split products,
    at each head_dim) split into ``K4 fwd``, ``K4 fwd (f32)``, ``K4 fwd
    (d16)`` and ``K4 fwd (d16 f32)``, and so on; on a path whose float32
    K4 launches took the head_dim-16 kernels the split pass counts as
    ``K4 split (d16)``."""
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k.replace(" ", "_"): 0 for k in counters}
    want.update(expected)
    on_hopper = {k: sum(getattr(fn, n) for n in HOPPER_COUNTS
                        if hasattr(fn, n))
                 for k, fn in counters.items()
                 if any(hasattr(fn, n) for n in HOPPER_COUNTS)}
    on_wide = {k: fn.wide_launches for k, fn in counters.items()
               if hasattr(fn, "wide_launches")}
    log(f"[{tag}] launches {launches}; of them on the Hopper kernels "
        f"{on_hopper}, on K3's split kernel {on_wide}")
    if {k.replace(" ", "_"): v for k, v in launches.items()} != want:
        raise SystemExit(f"{tag} launches {launches}, expected {want}")
    want_hopper = {k: launches[k] for k in on_hopper}
    want_wide = {k: (wide or {}).get(k, 0) for k in on_wide}
    if on_hopper != want_hopper or on_wide != want_wide:
        raise SystemExit(f"{tag}: a launch took the wrong one of its "
                         f"wrapper's kernels: {on_hopper} (split {on_wide}) "
                         f"of {launches}, expected {want_hopper} (split "
                         f"{want_wide})")
    by_entry = dict(launches)
    tag32 = " f32" if f32 else ""
    for k, hopper_entry, other in (
            ("K2", "K2 (hopper" + tag32 + ")", "K2"),
            ("K2 wgrad", "K2 wgrad (hopper" + tag32 + ")", "K2 wgrad"),
            ("K3", "K3 (wgmma f32)" if f32 else "K3",
             "K3 (f32)" if f32 else "K3 (mma.sync)"),
            ("K3 train", "K3 train (wgmma f32)" if f32 else "K3 train",
             "K3 train (mma.sync)")):
        split = on_wide.get(k, 0)
        del by_entry[k]  # the wrapper's count, split into its kernels
        by_entry[hopper_entry] = on_hopper[k] - split
        by_entry[other] = launches[k] - on_hopper[k]
        if k in on_wide:
            by_entry[f"{k} (wide{tag32})"] = split
    for k in ("K4 fwd", "K4 bwd dKdV", "K4 bwd dQ"):
        if k in counters:
            fn = counters[k]
            by_entry[k] = fn.wgmma_launches
            by_entry[f"{k} (f32)"] = fn.f32_launches
            by_entry[f"{k} (d16)"] = fn.d16_launches
            by_entry[f"{k} (d16 f32)"] = fn.d16_f32_launches
    if "K4 split" in by_entry and any(
            by_entry.get(f"{k} (d16 f32)") for k in ("K4 fwd", "K4 bwd dKdV")):
        by_entry["K4 split (d16)"] = by_entry.pop("K4 split")
    return by_entry


def k3_stock_chain(torch, xs, y, p):
    """The stock bf16 chain LN → ``F.linear`` → GELU → ``F.linear`` → γ,
    residual on K3's inputs (a yardstick, not one call)."""
    import torch.nn.functional as F

    C = xs.shape[-1]
    w1t = p["w1"].t().contiguous().to(torch.bfloat16)
    w2t = p["w2"].t().contiguous().to(torch.bfloat16)
    b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
    gam = p["gamma"].to(torch.bfloat16)

    def stock():
        t = F.layer_norm(y.float(), (C,), p["ln_w"], p["ln_b"],
                         1e-6).to(torch.bfloat16)
        h = F.gelu(F.linear(t, w1t, b1), approximate="tanh")
        return xs + F.linear(h, w2t, b2) * gam
    return stock


GRAD_FLOOR = 1e-3              # of the global gradient norm; see rel_grad_errs


def rel_grad_errs(torch, got, ref, floor=0.0):
    """Each parameter's gradient error relative to that gradient's norm,
    with two allowances. An attention key bias shifts every logit of a query
    alike, so its true gradient is 0 and what arrives is rounding noise: it
    is held relative to the query bias's gradient beside it. And a gradient
    under ``floor`` of the global norm (the ViViT comparisons pass
    GRAD_FLOOR: the query and key of a temporal block whose attention is
    close to uniform) is the small difference of large terms and carries
    their bf16 noise: it is held relative to that floor."""
    floor = floor * math.sqrt(sum(float(v.norm()) ** 2 for v in ref.values()))

    def scale(n):
        own = float(ref[n.replace(".key.bias", ".query.bias")].norm())
        return max(own, floor)

    return {n: float((got[n] - ref[n]).norm()) / scale(n) for n in ref}


def training_step(torch, dev, cfg=None, tag="train", fall=True,
                  fused_mlp=None):
    """One optimizer step of the flagship (or of ``cfg``) through the
    port's entry points (``create_train_state``, ``make_train_step``; with
    ``fused_mlp`` given, ``build_model(..., fused_mlp=fused_mlp)`` and
    ``build_optimizer`` as ``create_train_state`` calls them) on a seeded
    uint8 batch [8, 50, 126, 224, 3]: launch counts, finite loss, a finite
    gradient for every parameter and a nonzero one for every block
    parameter; the same step with every kernel swapped for its plain
    version; faults in the backward that the comparison must see (γ's
    gradient off by 1% where blocks take K3, a dropped K2 db, and on a
    float32 model K2's dw off by 1%); with ``fall``, the loss falling over
    TRAIN_FALL_STEPS steps on a fixed batch with augmentation off."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.models import build_model
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.train import (
        TrainState, build_optimizer, create_train_state, make_train_step)

    cfg = cfg or ExperimentConfig()
    f32 = cfg.model.dtype == "float32"
    B, T = cfg.data.batch_size, cfg.data.num_frames
    if fused_mlp is None:
        model, state = create_train_state(
            cfg, torch.Generator().manual_seed(3),
            steps_per_epoch=STEPS_PER_EPOCH)
    else:
        model = build_model(cfg.model, fused_mlp=fused_mlp,
                            generator=torch.Generator().manual_seed(3),
                            frame_size=cfg.data.frame_size)
        state = TrainState(*build_optimizer(cfg.optim, model.parameters(),
                                            STEPS_PER_EPOCH),
                           float(cfg.optim.grad_clip_norm))
    step = make_train_step(model, cfg)
    g = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (B, T, *CONTENT, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    targets = (torch.arange(B) % cfg.model.num_classes).to(dev)
    mask = torch.ones(B, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_init = copy.deepcopy(state.optimizer.state_dict())

    def run(seed, fn=step, keep_grads=True):
        """One step from the initial weights and optimizer state."""
        model.load_state_dict(init)
        state.optimizer.load_state_dict(opt_init)
        state.step = 0
        _, m = fn(state, frames, targets, mask,
                  torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        grads = ({n: p.grad.detach().float().clone()
                  for n, p in model.named_parameters()} if keep_grads else None)
        return {k: float(v) for k, v in m.items()}, grads

    counters = zero_counters()
    t0 = time.perf_counter()
    metrics, grads = run(TRAIN_SEED)
    first_s = time.perf_counter() - t0
    log(f"[{tag}] first step {first_s:.2f} s, metrics {metrics}")
    blocks, fused, on_wide = block_launches(torch, model)
    launches = expect_launches(tag, counters, f32=f32,
                               wide={"K3 train": on_wide},
                               K2=2 * blocks, K2_wgrad=blocks,
                               K3_train=fused)
    if not math.isfinite(metrics["loss"]):
        raise SystemExit(f"non-finite loss {metrics}")
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    block_params = [n for n in grads if ".stage" in n and "_block" in n]
    n_blocks = len({n.split(".")[1] for n in block_params})
    zero = [n for n in block_params if float(grads[n].abs().max()) == 0.0]
    log(f"[{tag}] {len(grads)} parameters with a gradient; non-finite "
        f"{bad}; {n_blocks} blocks, zero block gradients {zero}")
    if bad or zero or n_blocks != blocks:
        raise SystemExit("a parameter's gradient is missing, non-finite or "
                         "zero")

    plain = ((k2, "_launch_fwd", k2.dwconv7x7_plain),
             (k2, "_launch_wgrad", k2.dwconv7x7_wgrad_plain),
             (k3, "_launch_train", k3.convnext_mlp_train_plain))
    with swapped(*plain):
        plain_metrics, plain_grads = run(TRAIN_SEED)
    loss_err = abs(metrics["loss"] - plain_metrics["loss"]) / abs(
        plain_metrics["loss"])
    errs = rel_grad_errs(torch, grads, plain_grads)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"[{tag}] kernels vs plain: loss {metrics['loss']:.6f} vs "
        f"{plain_metrics['loss']:.6f} (rel {loss_err:.2e}); worst gradient "
        f"errors {[(n, f'{e:.2e}') for n, e in worst]} (tol {TRAIN_TOL:.0e})")
    if loss_err > TRAIN_TOL or worst[0][1] > TRAIN_TOL:
        raise SystemExit("training step disagrees with its plain version")

    # The comparison's power: faults in the backward, each in the plain step
    bwd, dw_bwd = k3.convnext_mlp_bwd, k2._DwConv7x7.backward

    def bwd_gamma_off(*args):
        grads_ = bwd(*args)
        return grads_[:-1] + (grads_[-1] * 1.01,)

    def dw_bwd_no_db(ctx, gy):
        dx, dw, db = dw_bwd(ctx, gy)
        return dx, dw * 1.01 if f32 else dw, torch.zeros_like(db)

    with swapped(*plain, (k3, "convnext_mlp_bwd", bwd_gamma_off),
                 (k2._DwConv7x7, "backward", staticmethod(dw_bwd_no_db))):
        _, fault_grads = run(TRAIN_SEED)
    ferrs = rel_grad_errs(torch, fault_grads, grads)

    def least(suffix):
        return min(e for n, e in ferrs.items() if n.endswith(suffix))

    power = {"k2_db_dropped": least(".dwconv.bias")}
    if fused:  # the γ of a block that takes K3 gets its gradient there
        power["dgamma_1pct"] = least(".gamma")
    if f32:
        power["k2_dw_1pct"] = least(".dwconv.weight")
    log(f"[{tag}] faults, least relative gradient error over the affected "
        f"parameters: {power} (must exceed tol {TRAIN_TOL:.0e})")
    if not all(v > TRAIN_TOL for v in power.values()):
        raise SystemExit(f"the tolerance does not see a backward fault: {power}")
    summary = {"launches": launches, "metrics": metrics,
               "first_step_s": first_s, "plain_metrics": plain_metrics,
               "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
               "tol": TRAIN_TOL, "faults_least_rel_err": power}
    out = {"cfg": cfg, "model": model, "state": state, "step": step,
           "batch": (frames, targets, mask), "summary": summary}
    if not fall:
        model.load_state_dict(init)
        state.optimizer.load_state_dict(opt_init)
        return out

    fixed_cfg = cfg.override({"augment.enabled": False,
                              "augment.horizontal_flip_prob": 0.0})
    fixed_step = make_train_step(model, fixed_cfg)
    model.load_state_dict(init)
    state.optimizer.load_state_dict(opt_init)
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        _, m = fixed_step(state, frames, targets, mask,
                          torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        losses.append(float(m["loss"]))
    log(f"[{tag}] fixed batch, augmentation off: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses}")
    summary["fixed_batch_losses"] = losses
    return out


def median_step_ms(torch, fn, warmup, iters):
    """Host clock around each call, each ending in a synchronise; median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_training(torch, dev, tr):
    """The training step with the kernels (the default) and with stock
    blocks, in turns (``in_turns``), and the share of
    ``train_preprocess``."""
    from vision_collision_detection_tpu_torch.models import build_model
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        train_preprocess)
    from vision_collision_detection_tpu_torch.train import (
        TrainState, build_optimizer, make_train_step)

    cfg = tr["cfg"]
    frames, targets, mask = tr["batch"]
    B = frames.shape[0]
    stock = build_model(cfg.model, device=dev, dwconv_kernel=False,
                        fused_mlp=False,
                        generator=torch.Generator().manual_seed(3))
    stock_state = TrainState(*build_optimizer(cfg.optim, stock.parameters(),
                                              STEPS_PER_EPOCH))
    variants = {"kernels": (tr["state"], tr["step"]),
                "stock": (stock_state, make_train_step(stock, cfg))}
    gen = torch.Generator(device=dev).manual_seed(7)

    def one(name):
        state, fn = variants[name]
        return lambda: fn(state, frames, targets, mask, gen)

    out = in_turns(
        torch, "train time", {name: one(name) for name in variants},
        lambda fn: median_step_ms(torch, fn, warmup=2, iters=TRAIN_TIME_ITERS),
        B)
    pre_ms = median_step_ms(torch, lambda: train_preprocess(
        gen, frames, cfg.augment, cfg.data.frame_size,
        getattr(torch, cfg.model.dtype)), warmup=1, iters=TRAIN_TIME_ITERS)
    out["train_preprocess_ms"] = pre_ms
    out["train_preprocess_share"] = pre_ms / out["kernels"]["ms"]
    log(f"[train time] train_preprocess {pre_ms:.2f} ms "
        f"({out['train_preprocess_share']:.3f} of the step)")
    return out


def profile_training(torch, tr):
    """Device time by kernel over one training step (torch.profiler): K2's
    forward kernel (forward and dx), K2 wgrad, K3 train, K3's torch
    backward and train_preprocess (each a record_function range around
    their calls), the rest; and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.train import steps

    def ranged(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    frames, targets, mask = tr["batch"]
    gen = torch.Generator(device=frames.device).manual_seed(8)

    def run():
        tr["step"](tr["state"], frames, targets, mask, gen)

    with swapped((k3, "convnext_mlp_bwd",
                  ranged("vcd_k3_backward", k3.convnext_mlp_bwd)),
                 (k2._DwConv7x7, "backward", staticmethod(
                     ranged("vcd_k2_backward", k2._DwConv7x7.backward))),
                 (steps, "train_preprocess",
                  ranged("vcd_train_preprocess", steps.train_preprocess))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = {"K3 torch backward": "vcd_k3_backward",
              "train_preprocess": "vcd_train_preprocess"}
    rows = []
    for e in prof.key_averages():
        # a record_function range also shows as a device-side annotation
        # spanning its kernels: not a kernel of its own
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or e.key in ranges.values()):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"kernel": e.key, "ms": us / 1e3, "launches": e.count})
    busy = sum(r["ms"] for r in rows)
    if busy <= 0:
        log("[train profile] the profiler recorded no device time: "
            "not measured")
        return None
    groups = {"K2 fwd and dx": ("dwconv7x7_hopper_kernel",
                                "dwconv7x7_kernel"),
              "K2 wgrad": ("dwconv_wgrad_hopper_kernel",
                           "wgrad_hopper_sum_parts", "dwconv_wgrad_kernel",
                           "wgrad_sum_parts"),
              "K3 train": ("convnext_mlp_wgmma_kernel",)}
    by_group = {name: sum(r["ms"] for r in rows
                          if any(k in r["kernel"] for k in keys))
                for name, keys in groups.items()}
    for name, label in ranges.items():
        us = sum(e.device_time_total for e in prof.events()
                 if e.name == label and e.device_type == DeviceType.CPU)
        by_group[name] = us / 1e3 if us > 0 else None
    by_group["rest"] = busy - sum(v for v in by_group.values() if v)
    k2_bwd = kernels_in_range(prof, "vcd_k2_backward")
    # the hand-written kernels launch through ctypes, outside any torch op,
    # so the range shows the torch ops' kernels: db, the taps' flip, casts
    log("[train profile] torch kernels in K2's backward, per step: "
        + ("; ".join(
            f"{v['launches']} x {k[:70]} {v['ms']:.3f} ms"
            for k, v in sorted(k2_bwd.items(), key=lambda kv: -kv[1]["ms"]))
            or "not measured"))
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1.0 - busy / wall_ms)
    log(f"[train profile] device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"per step (idle share {idle:.3f}); by part: "
        + ", ".join(f"{k} {v:.2f}" if v is not None else f"{k} not measured"
                    for k, v in by_group.items()))
    for r in rows[:15]:
        log(f"[train profile]   {r['ms']:.3f} ms x{r['launches']} "
            f"{r['kernel'][:100]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": idle,
            "by_part_ms": by_group, "k2_backward_kernels": k2_bwd,
            "db": time_k2_db(torch, frames.device), "top": rows[:30]}


def kernels_in_range(prof, label):
    """Device kernels of the torch ops under the record_function ranges
    ``label`` of a profile: name → launches and device ms."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.name != label or e.device_type != DeviceType.CPU:
            continue
        stack = [e]
        while stack:
            ev = stack.pop()
            for k in getattr(ev, "kernels", []):
                d = out.setdefault(k.name, {"launches": 0, "ms": 0.0})
                d["launches"] += 1
                d["ms"] += k.duration / 1e3
            stack.extend(ev.cpu_children)
    return out


def time_k2_db(torch, dev):
    """K2's bias gradient at the four stage shapes: Σg in float32 from a
    float32 copy of g (``g.to(float32).sum``, the earlier form) and summed
    as read (``g.sum(dtype=float32)``, the backward's), ms per launch and
    over the 18 blocks. Which kernels the step's form launches shows in the
    step's profile (the torch kernels under K2's backward)."""
    forms = {"copy_then_sum": lambda g: g.to(torch.float32).sum((0, 1, 2)),
             "sum_as_read": lambda g: g.sum((0, 1, 2), dtype=torch.float32)}
    gen = torch.Generator().manual_seed(9)
    out = {"per_stage": [], "step_ms": dict.fromkeys(forms, 0.0)}
    for H, C, blocks in STAGES:
        g = torch.randn(N_FRAMES, H, H, C, generator=gen).to(dev, torch.bfloat16)
        ms = {k: median_ms(torch, lambda f=f: f(g)) for k, f in forms.items()}
        diff = max_err(torch, forms["copy_then_sum"](g), forms["sum_as_read"](g))
        for k, v in ms.items():
            out["step_ms"][k] += v * blocks
        out["per_stage"].append({"shape": [N_FRAMES, H, H, C], "ms": ms,
                                 "max_abs_diff": diff})
        log(f"[train db] [{N_FRAMES}, {H}, {H}, {C}] x{blocks}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; max |difference| {diff:.3e}")
    log(f"[train db] over the 18 blocks: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out["step_ms"].items()))
    return out


# ---- 8. the scaled ViViT path ---------------------------------------------

VIVIT_OVERRIDES = {
    "model.backbone": "vivit_small", "model.temporal_mode": "attention",
    "model.patch_size": 14, "data.fps": 8, "data.duration": 4,
    "data.frame_size": 336, "augment.blur_sigma": 0.0,
    "model.attention_impl": "flash"}
VIVIT_CONTENT = (189, 336)     # 16:9 source letterboxed into 336²
VIVIT_S = 336
VIVIT_BATCH = 8
VIVIT_BLOCKS = 8               # spatial blocks, one K4 launch each
# Kernel step vs plain step on the ViViT: as TRAIN_TOL, but K4's forward
# rounds p at another scale than its plain version (flash_tols), in each of
# 8 blocks, so every activation behind a block differs by bf16 flips. The
# worst parameter, a first-block query bias (a sum over 147,456 tokens with
# much cancellation), reads 1.9e-2 on an H100; the limit is twice that, and
# a dv off by 10% must land outside it.
VIVIT_TRAIN_TOL = 4e-2
# The temporal blocks' query and key projections: their softmax runs over 32
# frame summaries that lie close together, so the gradient of a logit,
# a ⊙ (dp − Σ a·dp), is a difference of near-equal terms (these gradients'
# norms are 0.3% of the global norm) and the activations' flips weigh more.
VIVIT_TEMPORAL_QK_TOL = 1e-1
# AdamW's first steps move every weight by the rate whatever its gradient's
# size: at the default 1e-4 the fixed-batch loss of this 21 M-parameter
# transformer climbs to 4 before it falls, so that check runs at a tenth of
# it. There a step is smaller than most weights' bf16 spacing, so single
# steps are noisy (a weight's bf16 copy stays or moves a whole ulp) and the
# fall is read over VIVIT_FALL_STEPS steps.
VIVIT_FALL_RATE = 1e-5
VIVIT_REMAT_BATCH = 2


def vivit_cfg(**more):
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().override(dict(VIVIT_OVERRIDES, **more))


def flash_plain_swaps(fwd=None, dkv=None, dq=None):
    """K4's five launches swapped for their plain twins (or for a faulty
    twin, which takes the launcher's arguments: the backward's also
    ``split``), as ``swapped`` takes them."""
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    return ((fa, "_launch_fwd", fwd or fa._flash_fwd_plain),
            (fa, "_launch_bwd_dkv", dkv or fa.flash_mha_bwd_dkv_plain),
            (fa, "_launch_bwd_dq", dq or fa.flash_mha_bwd_dq_plain),
            (fa, "_launch_bwd_di", fa._row_dot),
            (fa, "_launch_split", fa.flash_mha_split_plain))


def vivit_predictor(torch, dev, cfg, content=VIVIT_CONTENT,
                    table=(576, 384)):
    """Phase 9's predictor of ``cfg`` (seeded weights, on the card; biases
    and LayerNorms redrawn as in phase 3, so a dropped one shows; the head
    scaled by LOGIT_SCALE) and its seeded uint8 batch [8, 32, *content,
    3] ([8, 32, 189, 336, 3]); ``table``: the spatial position table's
    shape (tokens, dim) the configuration must build."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    pred = CollisionPredictor(cfg, None)
    if tuple(pred.model.spatial_pos.shape) != table:
        raise SystemExit(f"position table {tuple(pred.model.spatial_pos.shape)}")
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in pred.model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in pred.model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
        pred.model.head.weight.mul_(LOGIT_SCALE)
    T = cfg.data.num_frames
    if pred._fold_stride() != 1 or T != 32:
        raise SystemExit(f"fold stride {pred._fold_stride()}, T {T}")
    frames = torch.stack([
        torch.randint(12 * i, 256 - 16 * i, (T, *content, 3),
                      generator=g, dtype=torch.uint8)
        for i in range(VIVIT_BATCH)]).to(dev)
    return pred, frames


def vivit_serving(torch, dev):
    """The scaled configuration's serving forward through
    ``CollisionPredictor._make_forward(folded_stride=False)`` on a seeded
    uint8 batch [8, 32, 189, 336, 3]: launch counts (K1 1, K4 fwd 8, all
    else 0), probabilities that spread, agreement with the same forward on
    plain versions, and the softmax scale dropped in one block seen."""
    from vision_collision_detection_tpu_torch.ops import (
        dequant_pad, flash_attention as fa, preprocess)

    cfg = vivit_cfg()
    pred, frames = vivit_predictor(torch, dev, cfg)
    forward = pred._make_forward(folded_stride=False)
    torch.cuda.synchronize()

    counters = zero_counters()
    probs = forward(frames)
    torch.cuda.synchronize()
    launches = expect_launches("vivit serve", counters, K1=1,
                               K4_fwd=VIVIT_BLOCKS)
    log(f"[vivit serve] probs {probs.tolist()}")
    if tuple(probs.shape) != (VIVIT_BATCH, 3) or not bool(
            torch.isfinite(probs).all()):
        raise SystemExit(f"bad probabilities {probs}")
    row_err = float((probs.sum(-1) - 1).abs().max())
    if row_err > 1e-5:
        raise SystemExit(f"probability rows do not sum to 1 ({row_err})")
    spread = float((probs.max(0).values - probs.min(0).values).max())
    log(f"[vivit serve] largest spread of one class across clips {spread:.4f}")
    if spread < SPREAD_MIN:
        raise SystemExit(f"probabilities too alike to test with ({spread})")

    def plain_forward(fwd=None):
        with swapped(*flash_plain_swaps(fwd=fwd),
                     (preprocess, "dequant_normalize_pad",
                      dequant_pad.dequant_normalize_pad_plain)):
            out = forward(frames)
            torch.cuda.synchronize()
        return out

    err = max_err(torch, probs, plain_forward())
    # bf16 activations through 12 blocks: flips between kernel and plain
    # propagate; probabilities must agree to 2e-2 absolute, as in phase 3
    tol = 2e-2
    log(f"[vivit serve] kernels vs plain: max |Δprob| {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise SystemExit("ViViT serving forward disagrees with its plain version")

    def scale_dropped_in(block):
        calls = [0]

        def fwd(q, k, v, sm_scale, need_lse=True):
            calls[0] += 1
            return fa._flash_fwd_plain(
                q, k, v, 1.0 if calls[0] == block else sm_scale, need_lse)
        return fwd

    power = {f"sm_scale_dropped_in_block_{b}": max_err(
        torch, probs, plain_forward(scale_dropped_in(b)))
        for b in (1, VIVIT_BLOCKS)}
    for name, v in power.items():
        log(f"[vivit serve] with fault {name}: max |Δprob| {v:.3e} (must "
            f"exceed tol {tol:.0e})")
    if not all(v > tol for v in power.values()):
        raise SystemExit(f"the tolerance does not see a dropped scale: {power}")
    return {"cfg": cfg, "pred": pred, "forward": forward, "frames": frames,
            "summary": {"launches": launches, "probs": probs.tolist(),
                        "max_abs_err_vs_plain": err, "tol": tol,
                        "spread_across_clips": spread,
                        "faults_max_abs_err": power, "row_sum_err": row_err}}


def time_vivit_forward(torch, serve):
    """The ViViT serving forward with ``attention_impl`` "flash" (K4) and
    "xla" (stock attention) on the same weights, in turns (A B, B A); peak
    memory of each; the profile of the "flash" forward."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    frames = serve["frames"]
    xla = CollisionPredictor(
        serve["cfg"].override({"model.attention_impl": "xla"}),
        serve["pred"].model.state_dict())
    forwards = {"flash": serve["forward"], "xla": xla._make_forward(False)}
    diff = max_err(torch, forwards["flash"](frames), forwards["xla"](frames))
    log(f"[vivit forward] flash vs xla: max |Δprob| {diff:.3e}")
    out = in_turns(torch, "vivit forward", {
        name: (lambda fwd=fwd: fwd(frames)) for name, fwd in forwards.items()},
        lambda fn: median_ms(torch, fn, warmup=2, iters=10,
                            queued=False), VIVIT_BATCH)
    out["flash_vs_xla_max_abs_dprob"] = diff
    out["profile"] = profile_device(
        torch, "vivit forward", lambda: forwards["flash"](frames), 3,
        {"K1": "dequant_pad_rows", "K4 fwd": "flash_fwd_wgmma_kernel"})
    return out


def in_turns(torch, tag, variants, measure, batch):
    """Each variant measured in turns (A B C, then C B A), its time the
    mean of the two readings; peak device memory of one run of each."""
    times = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            times[name].append(measure(variants[name]))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        variants[name]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[name] = {"ms": ms, "clips_per_s": batch / ms * 1e3, "batch": batch,
                     "rounds_ms": ts, "peak_mem_bytes": peak}
        log(f"[{tag}] {name}: {ms:.3f} ms per batch of {batch}, "
            f"{batch / ms * 1e3:.2f} clips/s (rounds {ts[0]:.3f}, "
            f"{ts[1]:.3f}); peak device memory {peak / 1e9:.2f} GB")
    return out


def vivit_training(torch, dev):
    """One optimizer step of the scaled configuration through
    ``create_train_state`` and ``make_train_step`` on a seeded uint8 batch
    [8, 32, 189, 336, 3] with the default augmentation (blur off): launch
    counts (each K4 kernel 8, the di kernel among them), a finite gradient for every parameter and a
    nonzero one for every spatial block's projections; the same step on
    plain versions; a fault in the dQ kernel's plain twin seen; the loss
    falling on a fixed batch; remat on against off at B=2."""
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa
    from vision_collision_detection_tpu_torch.train import (
        TrainState, build_optimizer, create_train_state, make_train_step)

    cfg = vivit_cfg()
    T = cfg.data.num_frames

    def batch_of(B, seed):
        """Noise frames, each frame of its own brightness, so that the
        temporal blocks see frames that differ."""
        g = torch.Generator().manual_seed(seed)
        noise = torch.randint(48, 208, (B, T, *VIVIT_CONTENT, 3), generator=g,
                              dtype=torch.int16)
        level = torch.randint(-48, 48, (B, T, 1, 1, 1), generator=g,
                              dtype=torch.int16)
        return ((noise + level).to(torch.uint8).to(dev),
                (torch.arange(B) % cfg.model.num_classes).to(dev),
                torch.ones(B, device=dev))

    def fresh(cfg_):
        model, state = create_train_state(
            cfg_, torch.Generator().manual_seed(13),
            steps_per_epoch=STEPS_PER_EPOCH)
        return model, state, make_train_step(model, cfg_)

    def grads_of(model):
        return {n: p.grad.detach().float().clone()
                for n, p in model.named_parameters()}

    failed = []
    model, state, step = fresh(cfg)
    batch = batch_of(VIVIT_BATCH, 14)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_init = copy.deepcopy(state.optimizer.state_dict())

    def run(fn=step):
        """One step from the initial weights and optimizer state."""
        model.load_state_dict(init)
        state.optimizer.load_state_dict(opt_init)
        state.step = 0
        _, m = fn(state, *batch,
                  torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        torch.cuda.synchronize()
        return {k: float(v) for k, v in m.items()}, grads_of(model)

    counters = zero_counters()
    t0 = time.perf_counter()
    metrics, grads = run()
    first_s = time.perf_counter() - t0
    log(f"[vivit train] first step {first_s:.2f} s, metrics {metrics}")
    launches = expect_launches(
        "vivit train", counters, K4_fwd=VIVIT_BLOCKS,
        K4_bwd_dKdV=VIVIT_BLOCKS, K4_bwd_dQ=VIVIT_BLOCKS,
        K4_bwd_di=VIVIT_BLOCKS, train_preprocess=2)
    if not math.isfinite(metrics["loss"]):
        raise SystemExit(f"non-finite loss {metrics}")
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    # a key bias shifts every logit of a query alike, so its true gradient
    # is 0: the weights of all four projections and the other three biases
    # must see a gradient
    attn = [n for n in grads if n.startswith("spatial_") and ".attn." in n
            and not n.endswith(".key.bias")]
    zero = [n for n in attn if float(grads[n].abs().max()) == 0.0]
    log(f"[vivit train] {len(grads)} parameters with a gradient; non-finite "
        f"{bad}; {len(attn)} spatial attention parameters, zero {zero}")
    if bad or zero or len(attn) != 7 * VIVIT_BLOCKS:
        failed.append("a parameter's gradient is missing, non-finite or zero")

    with swapped(*flash_plain_swaps()):
        plain_metrics, plain_grads = run()
    loss_err = abs(metrics["loss"] - plain_metrics["loss"]) / abs(
        plain_metrics["loss"])
    errs = rel_grad_errs(torch, grads, plain_grads, GRAD_FLOOR)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    total = math.sqrt(sum(float(v.norm()) ** 2 for v in plain_grads.values()))
    log(f"[vivit train] global gradient norm {total:.4f}; norms of the worst: "
        f"{[(n, f'{float(plain_grads[n].norm()):.2e}') for n, _ in worst]}")
    log(f"[vivit train] kernels vs plain: loss {metrics['loss']:.6f} vs "
        f"{plain_metrics['loss']:.6f} (rel {loss_err:.2e}); worst gradient "
        f"errors {[(n, f'{e:.2e}') for n, e in worst]}")
    loose = {n: e for n, e in errs.items() if n.startswith("temporal_")
             and (".attn.query." in n or ".attn.key." in n)}
    worst_loose = max(loose.items(), key=lambda kv: kv[1])
    worst_rest = max(((n, e) for n, e in errs.items() if n not in loose),
                     key=lambda kv: kv[1])
    log(f"[vivit train] worst temporal query/key {worst_loose} (tol "
        f"{VIVIT_TEMPORAL_QK_TOL:.0e}); worst of all other parameters "
        f"{worst_rest} (tol {VIVIT_TRAIN_TOL:.0e})")
    if (loss_err > VIVIT_TRAIN_TOL or worst_rest[1] > VIVIT_TRAIN_TOL
            or worst_loose[1] > VIVIT_TEMPORAL_QK_TOL):
        failed.append("the step disagrees with its plain version")

    # Both bf16 steps against the step in float32 (compute dtype float32,
    # K4 on its plain float32 version; remat on, so that its activations
    # fit beside the bf16 states: remat changes no number, see below): the
    # same batch, weights and generators. The kernel step must be no
    # further from float32 than twice the plain bf16 step on the temporal
    # query/key gradients, or what separates it from the plain step is more
    # than bf16 rounding.
    m32, s32, step32 = fresh(cfg.override({"model.dtype": "float32",
                                           "model.remat": True}))
    m32.load_state_dict(init)
    with swapped(*flash_plain_swaps()):
        _, m_ = step32(s32, *batch,
                       torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        torch.cuda.synchronize()
    f32_loss, f32_grads = float(m_["loss"]), grads_of(m32)
    del m32, s32, step32
    vs32 = {"kernel": rel_grad_errs(torch, grads, f32_grads, GRAD_FLOOR),
            "plain": rel_grad_errs(torch, plain_grads, f32_grads, GRAD_FLOOR)}
    f32_qk = {n: (vs32["kernel"][n], vs32["plain"][n]) for n in loose}
    f32_rest = {k: max(((n, e) for n, e in v.items() if n not in loose),
                       key=lambda kv: kv[1]) for k, v in vs32.items()}
    f32_worst_qk = {k: max(v[n] for n in loose) for k, v in vs32.items()}
    log(f"[vivit train] float32 step: loss {f32_loss:.6f}; relative gradient "
        f"error against it (kernel step, plain bf16 step):")
    for n, (ek, ep) in sorted(f32_qk.items()):
        log(f"[vivit train]   {n}: {ek:.3e}, {ep:.3e}")
    log(f"[vivit train]   worst temporal query/key: kernel "
        f"{f32_worst_qk['kernel']:.3e}, plain {f32_worst_qk['plain']:.3e}; "
        f"worst other parameter: kernel {f32_rest['kernel']}, plain "
        f"{f32_rest['plain']}")
    if f32_worst_qk["kernel"] > 2 * f32_worst_qk["plain"]:
        failed.append("the kernel step is further from float32 than twice "
                      "the plain bf16 step on the temporal query/key "
                      "gradients")
    del f32_grads

    # The comparison's power: the plain step with di left out of the dQ
    # twin's ds, and with the dK/dV twin's dv off by 10%
    def dq_no_di(q, k, v, do, lse, di, sm_scale, split=None):
        return fa.flash_mha_bwd_dq_plain(q, k, v, do, lse,
                                         torch.zeros_like(di), sm_scale)

    def dkv_dv_off(*args, split=None):
        dk, dv = fa.flash_mha_bwd_dkv_plain(*args)
        return dk, (dv.float() * 1.10).to(dv.dtype)

    with swapped(*flash_plain_swaps(dq=dq_no_di, dkv=dkv_dv_off)):
        _, fault_grads = run()
    ferrs = rel_grad_errs(torch, fault_grads, grads, GRAD_FLOOR)
    power = {
        "dq_without_di": min(e for n, e in ferrs.items() if n.startswith(
            "spatial_") and n.endswith(".attn.query.weight")),
        "dv_10pct": min(e for n, e in ferrs.items() if n.startswith(
            "spatial_") and n.endswith(".attn.value.weight"))}
    log(f"[vivit train] faults, least relative gradient error over the "
        f"affected parameters: {power} (must exceed tol {VIVIT_TRAIN_TOL:.0e})")
    if not all(v > VIVIT_TRAIN_TOL for v in power.values()):
        failed.append(f"the tolerance does not see a backward fault: {power}")
    del plain_grads, fault_grads

    fixed_cfg = cfg.override({"augment.enabled": False,
                              "augment.horizontal_flip_prob": 0.0,
                              "optim.learning_rate": VIVIT_FALL_RATE})
    model.load_state_dict(init)
    fixed_state = TrainState(
        *build_optimizer(fixed_cfg.optim, model.parameters(),
                         STEPS_PER_EPOCH),
        float(fixed_cfg.optim.grad_clip_norm))
    fixed_step = make_train_step(model, fixed_cfg)
    losses = []
    for _ in range(VIVIT_FALL_STEPS):
        _, m = fixed_step(fixed_state, *batch,
                          torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        losses.append(float(m["loss"]))
    log(f"[vivit train] fixed batch, augmentation off: losses {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"the loss did not fall: {losses}")

    # remat re-runs each spatial block's forward in the backward: the same
    # loss and gradients, K4's forward launched twice per block
    small = batch_of(VIVIT_REMAT_BATCH, 15)
    remat = {}
    for on in (False, True):
        m_, s_, step_ = fresh(cfg.override({"model.remat": on}))
        c = zero_counters()
        _, met = step_(s_, *small,
                       torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        torch.cuda.synchronize()
        expect_launches(f"vivit train remat={on}", c,
                        K4_fwd=VIVIT_BLOCKS * (2 if on else 1),
                        K4_bwd_dKdV=VIVIT_BLOCKS, K4_bwd_dQ=VIVIT_BLOCKS,
                        K4_bwd_di=VIVIT_BLOCKS, train_preprocess=2)
        remat[on] = (float(met["loss"]), grads_of(m_))
        del m_, s_, step_
    remat_loss = abs(remat[True][0] - remat[False][0]) / abs(remat[False][0])
    remat_err = max(rel_grad_errs(torch, remat[True][1], remat[False][1],
                                  GRAD_FLOOR).values())
    # the recomputed forward repeats the first on the same inputs; 1e-6
    # leaves room for a library kernel that sums in another order when run
    # inside the backward
    log(f"[vivit train] remat on vs off at B={VIVIT_REMAT_BATCH}: relative "
        f"|Δloss| {remat_loss:.3e}, worst relative gradient difference "
        f"{remat_err:.3e} (tol 1e-6)")
    if remat_loss > 1e-6 or remat_err > 1e-6:
        failed.append("remat changed the loss or a gradient")
    del remat
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"ViViT training step: {failed}")
    return {"cfg": cfg, "model": model, "state": state, "step": step,
            "batch": batch,
            "summary": {"launches": launches, "metrics": metrics,
                        "first_step_s": first_s,
                        "plain_metrics": plain_metrics,
                        "loss_rel_err": loss_err,
                        "worst_grad_rel_err": worst, "tol": VIVIT_TRAIN_TOL,
                        "worst_temporal_qk": worst_loose,
                        "tol_temporal_qk": VIVIT_TEMPORAL_QK_TOL,
                        "float32_loss": f32_loss,
                        "temporal_qk_vs_float32": f32_qk,
                        "worst_temporal_qk_vs_float32": f32_worst_qk,
                        "worst_other_vs_float32": f32_rest,
                        "worst_other": worst_rest,
                        "faults_least_rel_err": power,
                        "fixed_batch_losses": losses,
                        "fixed_batch_rate": VIVIT_FALL_RATE,
                        "remat_loss_diff": remat_loss,
                        "remat_worst_grad_rel_diff": remat_err}}


def time_vivit_training(torch, dev, tr):
    """The ViViT training step with "flash" and with "xla" attention in
    turns, peak memory of each, ``train_preprocess`` alone, and the
    profile of the "flash" step."""
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        train_preprocess)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    cfg = tr["cfg"]
    batch = tr["batch"]
    xla_cfg = cfg.override({"model.attention_impl": "xla"})
    xla_model, xla_state = create_train_state(
        xla_cfg, torch.Generator().manual_seed(13),
        steps_per_epoch=STEPS_PER_EPOCH)
    variants = {"flash": (tr["state"], tr["step"]),
                "xla": (xla_state, make_train_step(xla_model, xla_cfg))}
    gen = torch.Generator(device=dev).manual_seed(7)
    out = in_turns(torch, "vivit train time", {
        name: (lambda st=st, fn=fn: fn(st, *batch, gen))
        for name, (st, fn) in variants.items()},
        lambda fn: median_step_ms(torch, fn, warmup=2, iters=TRAIN_TIME_ITERS),
        batch[0].shape[0])
    del variants["xla"], xla_model, xla_state
    torch.cuda.empty_cache()
    pre_ms = median_step_ms(torch, lambda: train_preprocess(
        gen, batch[0], cfg.augment, cfg.data.frame_size,
        getattr(torch, cfg.model.dtype)), warmup=1, iters=TRAIN_TIME_ITERS)
    out["train_preprocess_ms"] = pre_ms
    out["train_preprocess_share"] = pre_ms / out["flash"]["ms"]
    log(f"[vivit train time] train_preprocess {pre_ms:.2f} ms "
        f"({out['train_preprocess_share']:.3f} of the flash step)")
    out["profile"] = profile_device(
        torch, "vivit train", lambda: tr["step"](tr["state"], *batch, gen), 1,
        {"K4 fwd": "flash_fwd_wgmma_kernel",
         "K4 bwd dKdV": "flash_bwd_dkv_kernel",
         "K4 bwd dQ": "flash_bwd_dq_kernel",
         "K4 bwd di": "flash_bwd_di_kernel"})
    return out


def time_flash_kernels(torch, dev, inputs):
    """K4's kernels per launch at FLASH_MAIN (the main path's shape; rows of
    the kernels line), at FLASH_TP (phase 21's shape a rank; the same
    rows, kept in its ``by_shape`` record) and at the other whole-model bf16
    shapes: the kernel, its plain version,
    ``F.scaled_dot_product_attention`` forward and
    backward (one call that returns dq, dk and dv, so both backward kernels
    carry its time), the di kernel beside ``_row_dot``, and the bound worked
    from the shape."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    rows, by_shape, tp_rows = [], [], []
    g = torch.Generator().manual_seed(21)
    for shape in FLASH_SHAPES[:5]:
        B, S, H, D, dtype = shape
        main = shape == FLASH_MAIN
        if main:
            q, k, v, do, o, lse, di = inputs["K4"]
        else:
            q, k, v, do = flash_inputs(torch, shape, dev, g)
            o, lse = fa.flash_mha_fwd(q, k, v, D ** -0.5)
            di = fa.flash_mha_bwd_di(o, do)
        scale = D ** -0.5
        n, stats = q.numel(), B * H * S * 4
        heads = B * H
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        with torch.no_grad():
            fwd_ms = median_ms(torch, lambda: fa.flash_mha(q, k, v, scale))
            with swapped((fa, "route", lambda dtype, head_dim: "mma")):
                mma_fwd = median_ms(torch, lambda: fa.flash_mha(q, k, v,
                                                                scale))
            lib_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
        fwd_lse_ms = median_ms(torch, lambda: fa.flash_mha_fwd(q, k, v, scale))
        args = (q, k, v, do, lse, di, scale)
        dkv_ms = median_ms(torch, lambda: fa.flash_mha_bwd_dkv(*args))
        dq_ms = median_ms(torch, lambda: fa.flash_mha_bwd_dq(*args))
        di_ms = median_ms(torch, lambda: fa.flash_mha_bwd_di(o, do))
        row_dot_ms = median_ms(torch, lambda: fa._row_dot(o, do))
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dot, retain_graph=True))
        del lib_out, leaves
        rec = {"shape": list(shape), "fwd_ms": fwd_ms,
               "mma_sync_fwd_ms": mma_fwd,
               "fwd_with_lse_ms": fwd_lse_ms, "dkv_ms": dkv_ms,
               "dq_ms": dq_ms, "di_ms": di_ms, "row_dot_ms": row_dot_ms,
               "library_fwd_ms": lib_fwd,
               "library_bwd_ms": lib_bwd,
               "fwd_tflops": 4 * S * S * D * heads / fwd_ms / 1e9,
               "bwd_tflops": 14 * S * S * D * heads / (dkv_ms + dq_ms) / 1e9,
               "bwd_all_ms": dkv_ms + dq_ms + di_ms}
        by_shape.append(rec)
        log(f"[time] K4 {list(shape)}: fwd {fwd_ms:.4f} ms "
            f"({rec['fwd_tflops']:.1f} TFLOP/s; with lse {fwd_lse_ms:.4f}; "
            f"mma.sync kernel {mma_fwd:.4f}; library {lib_fwd:.4f}), "
            f"dK/dV {dkv_ms:.4f}, dQ {dq_ms:.4f} "
            f"({rec['bwd_tflops']:.1f} TFLOP/s over both; library backward "
            f"{lib_bwd:.4f}), di kernel {di_ms:.4f} (_row_dot "
            f"{row_dot_ms:.4f}); dK/dV + dQ + di {rec['bwd_all_ms']:.4f}")
        if shape not in (FLASH_MAIN, FLASH_TP):
            continue
        with torch.no_grad():
            plain = {"K4 fwd": median_ms(
                torch, lambda: fa.flash_mha_plain(q, k, v, scale), iters=5)}
        plain["K4 bwd dKdV"] = median_ms(
            torch, lambda: fa.flash_mha_bwd_dkv_plain(*args), iters=5)
        plain["K4 bwd dQ"] = median_ms(
            torch, lambda: fa.flash_mha_bwd_dq_plain(*args), iters=5)
        plain["K4 bwd di"] = row_dot_ms
        # bytes: each input read once, each output written once (bf16; lse
        # and di float32); flops: 2·S²·D per product and (batch, head)
        work = {"K4 fwd": (fwd_ms, 4 * n * 2, 4, lib_fwd),
                "K4 bwd dKdV": (dkv_ms, 6 * n * 2 + 2 * stats, 8, lib_bwd),
                "K4 bwd dQ": (dq_ms, 5 * n * 2 + 2 * stats, 6, lib_bwd)}
        bounds = {kernel: bound_ms(n_bytes, products * S * S * D * heads,
                                   BF16_FLOPS)
                  for kernel, (_, n_bytes, products, _) in work.items()}
        # di: o and do read, di written; a multiply and an add per element on
        # the CUDA cores. No single PyTorch call returns float32 row sums of
        # bf16 products, so library_ms is null.
        work["K4 bwd di"] = (di_ms, 2 * n * 2 + stats, None, None)
        bounds["K4 bwd di"] = bound_ms(2 * n * 2 + stats, 2 * n, F32_FLOPS)
        krows = []
        for kernel, (ms, n_bytes, products, lib) in work.items():
            b, by = bounds[kernel]
            krows.append({"kernel": kernel, "shape": list(shape),
                          "per_forward": VIVIT_BLOCKS, "ms": ms,
                          "mma_sync_ms": mma_fwd if kernel == "K4 fwd"
                          else None,
                          "plain_ms": plain[kernel], "library_ms": lib,
                          "bound_ms": b, "bound_by": by,
                          "exp_floor_ms": None if kernel == "K4 bwd di"
                          else exp_floor_ms(S * S * heads)})
        if main:
            rows.extend(krows)
        else:
            rec["kernels"] = tp_rows = krows
    for r in rows + tp_rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"[time] {r['kernel']} {r['shape']} x{r['per_forward']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f}; library {lib})")
    return rows, by_shape


# K4's other routes, timed at their models' shapes: float32 at the scaled
# configuration's (FLASH_MAIN_F32) and head_dim 16 at vivit_tiny's
# (FLASH_D16; 2 spatial blocks).
VIVIT_TINY_BLOCKS = 2


def time_flash_routes(torch, dev, inputs,
                      shapes=(FLASH_MAIN_F32,) + FLASH_D16):
    """K4's float32 kernels (``"f32_wgmma"``) per launch at FLASH_MAIN_F32
    and head_dim 16's kernels (``"wgmma_d16"``, ``"f32_wgmma_d16"``) at
    FLASH_D16, each float32 kernel on split copies made beforehand, and
    the split pass (``K4 split``, ``K4 split (d16)``: the forward's of q,
    k, v and the backward's of q, k, v, do, one launch each); the kernels
    these routes replaced on the same inputs (the route forced to
    ``"mma"``: ``cuda_core_ms`` on float32, ``mma_sync_ms`` on bf16), the
    plain versions and ``F.scaled_dot_product_attention`` forward and
    backward in the same dtype (``library_ms``). Bounds: the bytes of the
    inputs and outputs at their dtype, and the function's products
    (2·S²·D flops each: forward 2, dK/dV 4, dQ 3) at the peak of the unit
    that can run them, whatever a design issues: bf16 one tensor-core
    product each; float32 three bf16 tensor-core products each, the least
    a float32-accurate product takes there (``design_bound_ms``: the split
    design's own count, forward 8, dK/dV 15, dQ 12). Beside them
    ``exp_floor_ms``: the S² exponentials a (batch, head) that each kernel
    evaluates, at the special-function unit's rate. The split pass: bytes,
    4 an element of each operand in and 2 of each part out. →
    (kernels-line rows, a record per shape)."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    rows, records = [], []
    g = torch.Generator().manual_seed(22)
    # products of the function, and the bf16 products the split design
    # issues for them (ops/csrc/flash_f32.cuh: forward 3 + 5, dK/dV
    # 3 + 6 + 3 + 3, dQ 3 + 6 + 3)
    products = {"fwd": 2, "bwd dKdV": 4, "bwd dQ": 3}
    issued = {"fwd": 8, "bwd dKdV": 15, "bwd dQ": 12}
    mma = lambda dtype, head_dim: "mma"  # noqa: E731
    for shape in shapes:
        B, S, H, D, dtype = shape
        if shape == FLASH_MAIN_F32:
            q, k, v, do, o, lse, di = inputs["K4 f32"]
        else:
            q, k, v, do = flash_inputs(torch, shape, dev, g)
            o, lse = fa.flash_mha_fwd(q, k, v, D ** -0.5)
            di = fa.flash_mha_bwd_di(o, do)
        scale = D ** -0.5
        args = (q, k, v, do, lse, di, scale)
        n, stats, heads = q.numel(), B * H * S * 4, B * H
        size = q.element_size()
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        rec = {"shape": list(shape), "route": fa.route(q.dtype, D)}
        split_route = rec["route"] in fa._SPLIT_ROUTES
        fwd_split = fa.flash_mha_split(q, k, v) if split_route else None
        bwd_split = fa.flash_mha_split(q, k, v, do) if split_route else None
        with torch.no_grad():
            rec["fwd_ms"] = median_ms(torch, lambda: fa._launch_fwd(
                q, k, v, scale, need_lse=False, split=fwd_split))
            rec["library_fwd_ms"] = median_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale))
            rec["plain_fwd_ms"] = median_ms(
                torch, lambda: fa.flash_mha_plain(q, k, v, scale), iters=5)
        rec["dkv_ms"] = median_ms(torch, lambda: fa.flash_mha_bwd_dkv(
            *args, split=bwd_split))
        rec["dq_ms"] = median_ms(torch, lambda: fa.flash_mha_bwd_dq(
            *args, split=bwd_split))
        rec["plain_dkv_ms"] = median_ms(
            torch, lambda: fa.flash_mha_bwd_dkv_plain(*args), iters=5)
        rec["plain_dq_ms"] = median_ms(
            torch, lambda: fa.flash_mha_bwd_dq_plain(*args), iters=5)
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        rec["library_bwd_ms"] = median_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dot, retain_graph=True))
        del lib_out, leaves, fwd_split, bwd_split
        if split_route:
            split_ops = {"fwd": (q, k, v), "bwd": (q, k, v, do)}
            rec["split_ms"] = {kind: median_ms(
                torch, lambda ops=ops: fa.flash_mha_split(*ops))
                for kind, ops in split_ops.items()}
            rec["plain_split_ms"] = {kind: median_ms(
                torch, lambda ops=ops: fa.flash_mha_split_plain(*ops),
                iters=5) for kind, ops in split_ops.items()}
        # the kernels the route replaced (mma.sync for bf16, the CUDA cores
        # for float32), the route forced, on the same inputs
        yard_key = "cuda_core_ms" if dtype == "float32" else "mma_sync_ms"
        with swapped((fa, "route", mma)):
            with torch.no_grad():
                old_o = fa.flash_mha(q, k, v, scale)
                old = {"fwd": median_ms(
                    torch, lambda: fa.flash_mha(q, k, v, scale), warmup=1,
                    iters=5)}
            old_dk, old_dv = fa.flash_mha_bwd_dkv(*args)
            old_dq = fa.flash_mha_bwd_dq(*args)
            old["dkv"] = median_ms(
                torch, lambda: fa.flash_mha_bwd_dkv(*args), warmup=1, iters=5)
            old["dq"] = median_ms(
                torch, lambda: fa.flash_mha_bwd_dq(*args), warmup=1, iters=5)
        dk, dv = fa.flash_mha_bwd_dkv(*args)
        rec[yard_key] = old
        # the yardstick computes the same function (no bound: both are held
        # to the plain version in compare_flash_kernels)
        rec["old_kernel_vs_route_max_abs"] = {
            name: max_err(torch, a, b) for name, a, b in (
                ("o", old_o, o), ("dq", old_dq, fa.flash_mha_bwd_dq(*args)),
                ("dk", old_dk, dk), ("dv", old_dv, dv))}
        del old_o, old_dk, old_dv, old_dq, dk, dv
        work = {"fwd": ("fwd_ms", 4 * n * size, "plain_fwd_ms",
                        "library_fwd_ms"),
                "bwd dKdV": ("dkv_ms", 6 * n * size + 2 * stats,
                             "plain_dkv_ms", "library_bwd_ms"),
                "bwd dQ": ("dq_ms", 5 * n * size + 2 * stats, "plain_dq_ms",
                           "library_bwd_ms")}
        per = VIVIT_BLOCKS if D == 64 else VIVIT_TINY_BLOCKS
        exp_floor = exp_floor_ms(S * S * heads)
        for kind, (key, n_bytes, plain, lib) in work.items():
            flops = 2 * products[kind] * (3 if split_route else 1)
            b, by = bound_ms(n_bytes, flops * S * S * D * heads, BF16_FLOPS)
            row = {"kernel": flash_entry(kind, dtype, D), "shape": list(shape),
                   "per_forward": per, "ms": rec[key],
                   "plain_ms": rec[plain], "library_ms": rec[lib],
                   "bound_ms": b, "bound_by": by, "exp_floor_ms": exp_floor,
                   yard_key: old[{"fwd": "fwd", "bwd dKdV": "dkv",
                                  "bwd dQ": "dq"}[kind]]}
            extra = ""
            if split_route:
                row["design_bound_ms"] = bound_ms(
                    n_bytes, 2 * issued[kind] * S * S * D * heads,
                    BF16_FLOPS)[0]
                extra = (f"; the design's own products "
                         f"{row['design_bound_ms']:.4f}")
            rows.append(row)
            log(f"[time] {row['kernel']} {list(shape)} x{per}: "
                f"{row['ms']:.4f} ms (bound {b:.4f} ms by {by}; exp floor "
                f"{exp_floor:.4f}; plain {row['plain_ms']:.4f}; library "
                f"{row['library_ms']:.4f}; the kernel it replaced "
                f"{row[yard_key]:.4f}{extra})")
        if split_route:
            for kind, ops, parts in (("fwd", 3, 7), ("bwd", 4, 10)):
                # a subtraction for each part after an operand's first
                b, by = bound_ms(4 * ops * n + 2 * parts * n,
                                 (parts - ops) * n, F32_FLOPS)
                row = {"kernel": flash_entry("split", dtype, D),
                       "shape": list(shape), "operands": ops,
                       "per_forward": per, "ms": rec["split_ms"][kind],
                       "plain_ms": rec["plain_split_ms"][kind],
                       "library_ms": None, "bound_ms": b, "bound_by": by}
                rows.append(row)
                log(f"[time] {row['kernel']} of {ops} operands "
                    f"{list(shape)} x{per}: {row['ms']:.4f} ms (bound "
                    f"{b:.4f} ms by {by}; plain {row['plain_ms']:.4f}; "
                    f"library none)")
        records.append(rec)
        if shape != FLASH_MAIN_F32:
            del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return rows, records


# The special-function unit's rate: 16 ex2 a clock per SM (4 a clock in
# each of an SM's four quadrants), 132 SMs on the H100 SXM.
EX2_PER_CLOCK_SM = 16
H100_SMS = 132


def sm_clock_hz():
    """The card's largest SM clock, as ``nvidia-smi --query-gpu=
    clocks.max.sm`` reads it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def exp_floor_ms(n_exp):
    """The least time for ``n_exp`` exponentials on the special-function
    unit at the card's largest SM clock: a floor beside a K4 kernel's
    bound, not a bound of its own (the bound counts bytes and products)."""
    return n_exp / (EX2_PER_CLOCK_SM * H100_SMS * sm_clock_hz()) * 1e3


def profile_device(torch, tag, run, n, groups):
    """Device time by kernel over ``n`` runs (torch.profiler), grouped by
    kernel-name substrings, and the device's idle share of the window's
    wall time (inflated by the profiler's own cost on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"kernel": e.key, "ms": us / 1e3 / n,
                     "launches": e.count / n})
    busy = sum(r["ms"] for r in rows)
    if busy <= 0:
        log(f"[{tag} profile] the profiler recorded no device time: "
            "not measured")
        return None
    by_group = {g: sum(r["ms"] for r in rows if key in r["kernel"])
                for g, key in groups.items()}
    by_group["other"] = busy - sum(by_group.values())
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1.0 - busy / wall_ms)
    log(f"[{tag} profile] device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"per run (idle share {idle:.3f}); by kernel: "
        + ", ".join(f"{g} {v:.3f}" for g, v in by_group.items()))
    for r in rows[:12]:
        log(f"[{tag} profile]   {r['ms']:.3f} ms x{r['launches']:.0f} "
            f"{r['kernel'][:100]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": idle,
            "by_group_ms": by_group, "top": rows[:25]}


# ---- 4. timing ---------------------------------------------------------

def time_kernels(torch, dev, inputs):
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops.convnext_mlp import (
        convnext_mlp, convnext_mlp_plain, convnext_mlp_train,
        convnext_mlp_train_plain)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)
    from vision_collision_detection_tpu_torch.ops.dwconv import (
        dwconv7x7_plain, dwconv7x7_wgrad_plain)

    rows = []
    u8, mean, std = inputs["K1"]
    n_bytes = u8.numel() + N_FRAMES * S * S * 3 * 2
    b, by = bound_ms(n_bytes, 0, BF16_FLOPS)
    # the ViViT's K1 (256 frames of 189×336 into 336²), beside the row
    u8v = torch.randint(0, 256, (256, *VIVIT_CONTENT, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(6)).to(dev)
    vb, _ = bound_ms(u8v.numel() + 256 * VIVIT_S * VIVIT_S * 3 * 2, 0,
                     BF16_FLOPS)
    rows.append({
        "kernel": "K1", "shape": list(u8.shape), "per_forward": 1,
        "ms": median_ms(torch, lambda: dequant_normalize_pad(u8, S, mean, std)),
        "plain_ms": median_ms(
            torch, lambda: dequant_normalize_pad_plain(u8, S, mean, std)),
        "library_ms": None, "bound_ms": b, "bound_by": by,
        "vivit_shape": list(u8v.shape),
        "vivit_ms": median_ms(torch, lambda: dequant_normalize_pad(
            u8v, VIVIT_S, mean, std)),
        "vivit_bound_ms": vb})
    del u8v
    for H, C, blocks in STAGES:
        x, w, bias = inputs[("K2", C)]
        n = x.numel()
        t, by = time_k2(torch, x, w, bias)
        plain_ms = median_ms(torch, lambda: dwconv7x7_plain(x, w, bias))
        # the Hopper kernel (the main path's) and dwconv.cu on the same
        # inputs, each its own entry of the kernels line
        for kernel, ms in (("K2 (hopper)", t["hopper"]),
                           ("K2 bf16", t["tile"])):
            rows.append({
                "kernel": kernel, "shape": list(x.shape),
                "per_forward": blocks, "ms": ms, "plain_ms": plain_ms,
                "library_ms": t["cudnn"], "bound_ms": t["bound"],
                "bound_by": by})
        xs, y, p = inputs[("K3", C)]
        M = n // C
        b, by = bound_ms(3 * n * 2 + 8 * C * C * 2, 16 * M * C * C,
                         BF16_FLOPS)
        stock_ms = median_ms(torch, k3_stock_chain(torch, xs, y, p))
        with swapped((k3, "route", lambda dtype, C: "mma")):
            mma_ms = {"K3": median_ms(torch, lambda: convnext_mlp(
                xs, y, approximate=True, **p)),
                      "K3 train": median_ms(torch, lambda: convnext_mlp_train(
                          xs, y, approximate=True, **p))}
        rows.append({
            "kernel": "K3", "shape": list(x.shape), "per_forward": blocks,
            "mma_sync_ms": mma_ms["K3"],
            "ms": median_ms(torch, lambda: convnext_mlp(
                xs, y, approximate=True, **p)),
            "plain_ms": median_ms(torch, lambda: convnext_mlp_plain(
                xs, y, approximate=True, **p)),
            "library_ms": None,
            "stock_chain_ms": stock_ms,
            "bound_ms": b, "bound_by": by})

        # K2 wgrad: the Hopper kernel and dwconv_wgrad.cu on the same
        # inputs, each its own entry of the kernels line
        gx, gy = inputs[("K2 wgrad", C)]
        t, by = time_k2_wgrad(torch, gx, gy)
        plain_ms = median_ms(torch, lambda: dwconv7x7_wgrad_plain(gx, gy))
        for kernel, ms in (("K2 wgrad (hopper)", t["hopper"]),
                           ("K2 wgrad", t["tile"])):
            rows.append({
                "kernel": kernel, "shape": list(x.shape),
                "per_forward": blocks, "ms": ms, "plain_ms": plain_ms,
                "library_ms": t["cudnn"], "bound_ms": t["bound"],
                "bound_by": by})
        # K3 train: x, y, out, t, m at 2 bytes per row-channel and h_pre at
        # 8, W1 and W2 once; the eval kernel's flops
        b, by = bound_ms(18 * n + 8 * C * C * 2, 16 * M * C * C, BF16_FLOPS)
        rows.append({
            "kernel": "K3 train", "shape": list(x.shape), "per_forward": blocks,
            "mma_sync_ms": mma_ms["K3 train"],
            "stock_chain_ms": stock_ms,
            "ms": median_ms(torch, lambda: convnext_mlp_train(
                xs, y, approximate=True, **p)),
            "plain_ms": median_ms(torch, lambda: convnext_mlp_train_plain(
                xs, y, approximate=True, **p)),
            "library_ms": None, "bound_ms": b, "bound_by": by})
    for r in rows:
        log(f"[time] {r['kernel']} {r['shape']} x{r['per_forward']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f}; library "
            f"{r['library_ms']}; stock chain {r.get('stock_chain_ms')}; "
            f"mma.sync kernel {r.get('mma_sync_ms')})")
    k1 = rows[0]
    log(f"[time] K1 {k1['vivit_shape']} → {VIVIT_S}²: {k1['vivit_ms']:.4f} ms "
        f"(bound {k1['vivit_bound_ms']:.4f} ms by bytes)")
    for name in ("K2", "K2 wgrad"):
        per = [r for r in rows if r["kernel"] == f"{name} (hopper)"]
        tile = [r for r in rows if r["kernel"] == (
            "K2 bf16" if name == "K2" else name)]
        log(f"[time] {name} per stage, ms per launch: Hopper kernel / "
            f"{'dwconv.cu' if name == 'K2' else 'dwconv_wgrad.cu'} / cuDNN "
            f"/ bound (operations)")
        for h, t in zip(per, tile):
            log(f"[time]   {h['shape']} x{h['per_forward']}: {h['ms']:.4f} / "
                f"{t['ms']:.4f} / {h['library_ms']:.4f} / "
                f"{h['bound_ms']:.4f}")
        log(f"[time]   over the 18 launches: " + " / ".join(
            f"{sum(r[k] * r['per_forward'] for r in rs):.3f}"
            for rs, k in ((per, "ms"), (tile, "ms"), (per, "library_ms"),
                          (per, "bound_ms"))))
    return rows


def time_forward(torch, serve):
    """The serving forward with both kernels in the blocks (the default),
    with one of them, and with stock blocks, in turns (``in_turns``)."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    frames = serve["frames"]
    forwards = {"kernels": serve["forward"]}
    for name, dw, mlp in (("k2_only", True, False), ("k3_only", False, True),
                          ("stock", False, False)):
        pred = CollisionPredictor(serve["pred"].cfg, None, dwconv_kernel=dw,
                                  fused_mlp=mlp)
        forwards[name] = pred._make_forward(True)
    return in_turns(
        torch, "forward",
        {name: (lambda fwd=fwd: fwd(frames)) for name, fwd in forwards.items()},
        lambda fn: median_ms(torch, fn, warmup=2, iters=10,
                            queued=False), frames.shape[0])


# ---- 12. checkpoint → predictor ----------------------------------------

def checkpoint_phase(torch, dev, flagship):
    """Phase 3's predictor saved by ``CheckpointStore`` as ``best`` and
    loaded on the card by ``CollisionPredictor.from_checkpoint(run_dir)``:
    probabilities on phase 3's batch bit-equal to the original's. A
    checkpoint with block 0's γ × 1.01 must not be bit-equal; one whose
    hyperparams name convnext_base must fail the strict load."""
    import tempfile

    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore
    from vision_collision_detection_tpu_torch.ckpt.checkpoint import (
        ARRAYS_FILE)
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    pred, frames = flagship["pred"], flagship["frames"]
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(os.path.join(tmp, "run"))
        hp = pred.cfg.to_dict()
        sd = pred.model.state_dict()
        t0 = time.perf_counter()
        store.save("best", arrays={"model": sd}, meta={"hyperparams": hp})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(store.path("best"), ARRAYS_FILE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = CollisionPredictor.from_checkpoint(store.run_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = pred._make_forward(True)(frames)
        got = loaded._make_forward(True)(frames)
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        log(f"[checkpoint] save {save_s:.3f} s, load onto the card "
            f"{load_s:.3f} s, {size / 1e6:.1f} MB; from_checkpoint vs the "
            f"saved predictor: max |Δprob| {err:.3e} (bit-equal required)")
        if not torch.equal(got, want):
            raise SystemExit("checkpoint: the loaded predictor is not "
                             "bit-equal to the saved one")
        del loaded

        gamma = next(k for k in sd if k.endswith("gamma"))
        bad = dict(sd, **{gamma: sd[gamma] * 1.01})
        store.save("epoch_0", arrays={"model": bad}, meta={"hyperparams": hp})
        fault = CollisionPredictor.from_checkpoint(store.path("epoch_0"))
        fault_err = max_err(torch, fault._make_forward(True)(frames), want)
        log(f"[checkpoint] fault {gamma} × 1.01: max |Δprob| "
            f"{fault_err:.3e} ({'seen' if fault_err > 0 else 'NOT seen'})")
        if fault_err == 0:
            raise SystemExit("checkpoint: a scaled γ was not seen")
        del fault
        base = pred.cfg.override({"model.backbone": "convnext_base"})
        store.save("last", arrays={"model": sd},
                   meta={"hyperparams": base.to_dict()})
        try:
            CollisionPredictor.from_checkpoint(store.path("last"))
        except RuntimeError as e:
            refused = str(e).splitlines()[0][:120]
        else:
            raise SystemExit("checkpoint: convnext_tiny weights loaded under "
                             "a convnext_base contract")
        log(f"[checkpoint] fault convnext_base contract: refused ({refused})")
    torch.cuda.empty_cache()
    return {"save_s": save_s, "load_s": load_s, "bytes": size,
            "max_abs_err": err, "gamma_fault_max_abs_err": fault_err,
            "wrong_contract": refused}


# ---- 13. loader → device feed → predict's batch loop ---------------------

N_CLIPS = 32
BROKEN_CLIP = 5
# A device-side wait queued before every copy of the feed in the slow-link
# runs (about 50 ms on an H100: longer than a forward, and than the host
# takes to queue a batch's first kernel): the copies land late, so a feed
# that does not wait for them is caught on every batch, not only where it
# races. A 5 ms wait missed the faulty feed in most runs on an H100's
# host: it had queued the first batch's forward only after that batch's
# copy had landed.
SLOW_LINK_CYCLES = 100_000_000


class StandInClips:
    """A dataset of seeded uint8 content clips that needs no decoder: its
    ``get_batch`` returns the collated dict of ``ClipDataset.get_batch``,
    with one clip flagged ``error``. ``length`` > the clips serves them
    over again. ``labels`` (default all 0) are the clips' classes, which
    ``labels()`` and ``class_weights()`` report as ``ClipDataset``'s do;
    ``sensor`` [clips, T, 4] their IMU streams (default zeros)."""

    supports_batch = True

    def __init__(self, clips, broken, length=None, labels=None, sensor=None):
        import numpy as np

        self.clips, self.broken = clips, broken
        self.length = length or len(clips)
        self._labels = (np.zeros(len(clips), np.int64) if labels is None
                        else np.asarray(labels, np.int64))
        self.sensor = sensor

    def __len__(self):
        return self.length

    def labels(self):
        return self._labels[[i % len(self.clips) for i in range(self.length)]]

    def class_weights(self):
        from vision_collision_detection_tpu_torch.data.metadata import (
            compute_class_weights)

        return compute_class_weights(self.labels(), 3)

    def get_batch(self, idxs, epoch=0, num_threads=0):
        import numpy as np

        idxs = [int(i) % len(self.clips) for i in idxs]
        b, t = len(idxs), self.clips.shape[1]
        return {"frames": self.clips[idxs],
                "sensor": (np.zeros((b, t, 4), np.float32)
                           if self.sensor is None else self.sensor[idxs]),
                "target": self._labels[idxs],
                "id": [f"clip{i:02d}" for i in idxs],
                "error": np.asarray([i == self.broken for i in idxs]),
                "pad": np.zeros(b, bool)}


def predict_loop(torch, dev, pred):
    """``ClipLoader(batch_size=8)`` over a stand-in dataset of 32 clips
    [25, 126, 224, 3] → ``device_feed`` → ``_predict_batches``: each result
    bit-equal to ``_make_forward(True)`` fed the same clips directly, clip 5
    ``success: False``; again with every copy landing late (the feed must
    still wait for it); a feed that hands batches over before their copy
    and refills its ring early, and a loader that repeats the previous
    batch's frames, must not agree. Then the loop against the forward
    alone, in turns; the copy of one batch; the profile of the loop."""
    import numpy as np

    from vision_collision_detection_tpu_torch.data import loader as loader_mod
    from vision_collision_detection_tpu_torch.data.loader import ClipLoader

    g = torch.Generator().manual_seed(13)
    T = pred.cfg.data.num_frames // pred._fold_stride()
    clips = torch.stack([
        torch.randint(12 * (i % 8), 256 - 16 * (i % 8), (T, *CONTENT, 3),
                      generator=g, dtype=torch.uint8)
        for i in range(N_CLIPS)]).numpy()
    ds = StandInClips(clips, BROKEN_CLIP)
    path_by_id = {f"clip{i:02d}": f"clip{i:02d}.mp4" for i in range(N_CLIPS)}
    forward = pred._make_forward(True)
    batches = [torch.from_numpy(clips[k:k + 8]).to(dev)
               for k in range(0, N_CLIPS, 8)]
    direct = torch.cat([forward(b) for b in batches]).cpu().numpy()
    names = pred.class_names

    def run(loader=None):
        return pred._predict_batches(loader or ClipLoader(ds, 8), 2,
                                     path_by_id)

    def diff(results):
        """Largest |Δprob| of a clip against the direct forward (inf if a
        clip is missing or repeated, or its path or success flag is
        wrong)."""
        by_id = {r["id"]: r for r in results}
        if len(results) != N_CLIPS or set(by_id) != set(path_by_id):
            return math.inf
        worst = 0.0
        for i, vid in enumerate(path_by_id):
            r = by_id[vid]
            if r["video_path"] != path_by_id[vid] or \
                    r["success"] != (i != BROKEN_CLIP):
                return math.inf
            if r["success"]:
                p = np.asarray([r["probabilities"][n] for n in names])
                worst = max(worst, float(np.abs(p - direct[i]).max()))
        return worst

    torch.cuda.synchronize()
    counters = zero_counters()
    results = run()
    torch.cuda.synchronize()
    launches = expect_launches("predict", counters, K1=4, K2=72, K3=72)
    err = diff(results)
    if [r["id"] for r in results] != list(path_by_id):
        err = math.inf  # out of the loader's order
    log(f"[predict] 32 clips through loader → device_feed → "
        f"_predict_batches: max |Δprob| vs the forward fed directly {err:.3e}"
        f" (bit-equal required); clip {BROKEN_CLIP}: "
        f"{results[BROKEN_CLIP].get('error')}")
    if err != 0:
        raise SystemExit("predict: the batch loop disagrees with the forward")

    def slow_copy(buf, device):
        torch.cuda._sleep(SLOW_LINK_CYCLES)
        return buf.to(device, non_blocking=True)

    # Each in an order of its own, so that a batch read before its copy
    # finds no copy of its own frames in memory the allocator reuses
    def shuffled(seed):
        return ClipLoader(ds, 8, shuffle=True, seed=seed)

    with swapped((loader_mod, "_copy_to", slow_copy)):
        slow = diff(run(shuffled(7)))
    faults = {}
    with swapped((loader_mod, "_copy_to", slow_copy),
                 (loader_mod, "_wait_for_copy", lambda event: None),
                 (loader_mod, "_hand_over", lambda out, *a: out)):
        faults["feed_before_copy"] = diff(run(shuffled(8)))

    class Repeating(ClipLoader):
        def __iter__(self):
            prev = None
            for batch in super().__iter__():
                if prev is not None:
                    batch = dict(batch, frames=prev["frames"])
                prev = batch
                yield batch

    faults["repeated_batch"] = diff(run(Repeating(ds, 8)))
    log(f"[predict] every copy landing late: max |Δprob| {slow:.3e}; "
        + ", ".join(f"fault {k}: {v:.3e}" for k, v in faults.items()))
    if slow != 0:
        raise SystemExit("predict: the feed does not wait for a late copy")
    if not all(v > 0 for v in faults.values()):
        raise SystemExit(f"predict: a fault was not seen: {faults}")

    def forward_alone(n=4):
        for _ in range(n // 4):
            for b in batches:
                forward(b)

    long_ds = StandInClips(clips, BROKEN_CLIP, length=4 * N_CLIPS)
    # (function, batches): the loop and the forward alone over the 32 clips,
    # and over them four times (16 batches), in turns (A B C D, D C B A)
    variants = {
        "loop": (run, 4), "forward_alone": (forward_alone, 4),
        "loop_16": (lambda: run(ClipLoader(long_ds, 8)), 16),
        "forward_alone_16": (lambda: forward_alone(16), 16)}
    rounds = {k: [] for k in variants}
    for order in (list(variants), list(variants)[::-1]):
        for k in order:
            rounds[k].append(median_step_ms(torch, variants[k][0], 1, 3))
    turns = {}
    for k, (_, nb) in variants.items():
        ms = sum(rounds[k]) / 2
        turns[k] = {"ms": ms, "batches": nb, "rounds_ms": rounds[k],
                    "clips_per_s": 8 * nb / ms * 1e3}
        log(f"[predict loop] {k}: {ms:.3f} ms for {nb} batches of 8, "
            f"{8 * nb / ms * 1e3:.2f} clips/s (rounds {rounds[k][0]:.3f}, "
            f"{rounds[k][1]:.3f})")
    pinned = torch.from_numpy(clips[:8]).pin_memory()
    copy_ms = median_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    pageable = torch.from_numpy(clips[:8])
    pageable_ms = median_ms(torch, lambda: pageable.to(dev))
    # a batch more in the loop costs what it costs the forward alone where
    # its copy and the host's work are hidden; the rest is the pipeline's
    # fill, the first batch's fetch and staging before the card has work
    per_batch = (turns["loop_16"]["ms"] - turns["loop"]["ms"]) / 12
    per_batch_fwd = (turns["forward_alone_16"]["ms"]
                     - turns["forward_alone"]["ms"]) / 12
    fill = turns["loop"]["ms"] - 4 * per_batch
    hidden = 1.0 - min(1.0, max(0.0, (per_batch - per_batch_fwd) / copy_ms))
    log(f"[predict loop] one batch {pinned.numel() / 1e6:.1f} MB: pinned "
        f"copy {copy_ms:.3f} ms, pageable {pageable_ms:.3f} ms; a batch "
        f"more costs the loop {per_batch:.3f} ms and the forward alone "
        f"{per_batch_fwd:.3f}, so the loop hides {hidden:.3f} of each copy;"
        f" the pipeline's fill {fill:.3f} ms")
    groups = {"K1": "dequant_pad_rows", "K2": "dwconv7x7_hopper_kernel",
              "K3": "convnext_mlp_wgmma_kernel", "copy": "Memcpy"}
    profile = profile_device(torch, "predict loop", run, 2, groups)
    profile_16 = profile_device(torch, "predict loop 16",
                                variants["loop_16"][0], 1, groups)
    return {"launches": launches, "max_abs_err": err,
            "late_copies_max_abs_err": slow, "faults_max_abs_err": faults,
            "turns": turns, "batch_bytes": pinned.numel(),
            "copy_ms": copy_ms, "pageable_copy_ms": pageable_ms,
            "per_batch_ms": per_batch, "per_batch_forward_ms": per_batch_fwd,
            "fill_ms": fill, "copy_hidden_share": hidden,
            "profile": profile, "profile_16": profile_16}


# ---- 14. the sliding forward ---------------------------------------------

SLIDE_FRAMES, SLIDE_FPS, SLIDE_STRIDE_SEC = 300, 10.0, 1.0
SLIDE_TOL = 1e-4


def sliding_phase(torch, dev, pred):
    """``_sliding_forward`` over a seeded pool of 300 letterboxed frames
    [300, 224, 224, 3] (30 s at 10 fps, a window every second: 26 windows
    of 50 frames, padded to 320 and 32): launches K1 1, K2 18, K3 18; each
    window within SLIDE_TOL of ``_make_forward(False)`` on the same 32
    windows gathered on the host, and within 2e-2 of it fed 8 windows a
    call; every kernel swapped for its plain version within 2e-2; windows
    shifted by a frame must land outside SLIDE_TOL. Time, windows/s and
    peak memory."""
    import numpy as np

    from vision_collision_detection_tpu_torch.infer.predictor import (
        sliding_windows)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.ops import (
        convnext_mlp, dequant_pad, dwconv, preprocess)

    dc = pred.cfg.data
    g = torch.Generator().manual_seed(14)
    pool = torch.zeros((SLIDE_FRAMES, S, S, 3), dtype=torch.uint8)
    top = (S - CONTENT[0]) // 2
    pool[:, top:top + CONTENT[0]] = torch.randint(
        0, 256, (SLIDE_FRAMES, *CONTENT, 3), generator=g, dtype=torch.uint8)
    pool = pool.numpy()
    starts, _, win_idx = sliding_windows(
        SLIDE_FRAMES, SLIDE_FPS, dc.duration, dc.num_frames,
        SLIDE_STRIDE_SEC, 64)
    W = len(starts)

    torch.cuda.synchronize()
    counters = zero_counters()
    probs = pred._sliding_forward(pool, win_idx)
    torch.cuda.synchronize()
    launches = expect_launches("sliding", counters, K1=1, K2=18, K3=18)
    fwd = pred._make_forward(False)
    # the same 32 windows, padded as _sliding_forward pads them (windows of
    # frame 0), gathered on the host and fed in one call
    padded = np.zeros((-(-W // 8) * 8, win_idx.shape[1]), np.int64)
    padded[:W] = win_idx
    ref = fwd(pool[padded])[:W]
    err = max_err(torch, probs, ref)
    # 8 windows a call: bf16 flips where an op's sum order follows the batch
    by8 = torch.cat([fwd(pool[win_idx[k:k + 8]]) for k in range(0, W, 8)])
    by8_err = max_err(torch, probs, by8)
    with swapped((convnext, "dwconv7x7", dwconv.dwconv7x7_plain),
                 (convnext, "convnext_mlp", convnext_mlp.convnext_mlp_plain),
                 (preprocess, "dequant_normalize_pad",
                  dequant_pad.dequant_normalize_pad_plain)):
        plain_err = max_err(torch, pred._sliding_forward(pool, win_idx), ref)
    shifted_err = max_err(torch, pred._sliding_forward(pool, win_idx + 1),
                          ref)
    log(f"[sliding] {W} windows of {win_idx.shape[1]} frames from a pool of "
        f"{SLIDE_FRAMES}: max |Δprob| vs the same windows gathered on the "
        f"host {err:.3e} (tol {SLIDE_TOL:.0e}), fed 8 a call {by8_err:.3e} "
        f"(tol 2e-2); plain versions {plain_err:.3e} (tol 2e-2); windows "
        f"shifted by a frame {shifted_err:.3e} (must exceed "
        f"{SLIDE_TOL:.0e})")
    if tuple(probs.shape) != (W, 3) or not bool(torch.isfinite(probs).all()):
        raise SystemExit(f"sliding: bad probabilities {probs.shape}")
    if not (err <= SLIDE_TOL and by8_err <= 2e-2 and plain_err <= 2e-2
            and shifted_err > SLIDE_TOL):
        raise SystemExit("sliding: the windows disagree, or a shift of one "
                         "frame was not seen")

    ms = median_step_ms(torch, lambda: pred._sliding_forward(pool, win_idx),
                        1, 5)
    pool_dev = torch.from_numpy(pool).to(dev)
    on_card_ms = median_step_ms(
        torch, lambda: pred._sliding_forward(pool_dev, win_idx), 1, 5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pred._sliding_forward(pool, win_idx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[sliding] {ms:.3f} ms for {W} windows ({W / ms * 1e3:.2f} "
        f"windows/s), {on_card_ms:.3f} ms with the pool already on the card;"
        f" peak device memory {peak / 1e9:.2f} GB")
    del pool_dev
    torch.cuda.empty_cache()
    return {"launches": launches, "windows": W, "max_abs_err": err,
            "by8_max_abs_err": by8_err, "plain_max_abs_err": plain_err,
            "shifted_max_abs_err": shifted_err, "ms": ms,
            "windows_per_s": W / ms * 1e3, "pool_on_card_ms": on_card_ms,
            "peak_mem_bytes": peak}


# ---- 15. decode on the card ----------------------------------------------

def decode_phase(torch, dev, pred):
    """Where the machine has FFmpeg (``pkg-config --exists libavformat``):
    build the port's media library, encode three clips and run
    ``predict``, ``predict_sliding`` and ``evaluate`` on them. Elsewhere
    one line says that it was not run."""
    import shutil
    import tempfile

    import numpy as np

    found = shutil.which("pkg-config") and subprocess.run(
        ["pkg-config", "--exists", "libavformat"]).returncode == 0
    if not found:
        line = {"decode": "not run: no FFmpeg on this machine"}
        print(json.dumps(line), flush=True)
        return line
    from vision_collision_detection_tpu_torch.media import build, decoder

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(15)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(3):
            path = os.path.join(tmp, f"clip{i}.mp4")
            frames = rng.integers(20 * i, 200 + 20 * i, (100, 180, 320, 3),
                                  dtype=np.uint8)
            decoder.encode_video(path, frames, fps=10.0)
            paths.append(path)
        t0 = time.perf_counter()
        results = pred.predict(paths)
        predict_s = time.perf_counter() - t0
        windows = pred.predict_sliding(paths[0], stride_sec=1.0)
        metrics = pred.evaluate({"video_path": paths,
                                 "video_type": list(pred.class_names)})
    ok = (all(r["success"] for r in results) and len(windows) == 6
          and metrics["num_failed"] == 0
          and all(abs(sum(r["probabilities"].values()) - 1) < 1e-5
                  for r in results + windows))
    log(f"[decode] library built in {build_s:.1f} s; predict of 3 clips "
        f"{predict_s:.3f} s; {len(windows)} windows; accuracy "
        f"{metrics['accuracy']:.3f}")
    if not ok:
        raise SystemExit(f"decode: {results} {windows} {metrics}")
    return {"build_s": build_s, "predict_s": predict_s,
            "windows": len(windows), "metrics": metrics}


# ---- 16. the Trainer ------------------------------------------------------

TRAINER_CLIPS = (16, 8, 8)     # train (2 steps an epoch), val, test
TRAINER_BROKEN = 3             # the training clip flagged ``error``
TRAINER_TIME_STEPS = 16        # the loop and the steps alone, timed
# The flagship GRU head against a float64 copy on the CPU, largest
# absolute error of its output: float32 math lands near 1e-6, TF32 near
# 1e-3.
FP32_GRU_TOL = 1e-4


def trainer_data(torch, n, seed, T, sensor=False):
    """``n`` seeded content clips [T, 126, 224, 3], each of its own level
    and contrast, with labels in all three classes (and, with ``sensor``,
    seeded non-zero IMU streams [n, T, 4])."""
    import numpy as np

    g = torch.Generator().manual_seed(seed)
    clips = torch.stack([
        torch.randint(12 * (i % 8), 256 - 16 * (i % 8), (T, *CONTENT, 3),
                      generator=g, dtype=torch.uint8)
        for i in range(n)]).numpy()
    labels = (torch.randperm(n, generator=g) % 3).numpy()
    imu = (torch.randn(n, T, 4, generator=g).numpy().astype(np.float32) + 1.0
           if sensor else None)
    return clips, labels, imu


def count_calls(obj, name):
    """Wrap ``obj.name`` so that each call is counted (``counter[0]``) and
    its result kept (``kept``)."""
    fn, counter, kept = getattr(obj, name), [0], []

    def counted(*args, **kwargs):
        counter[0] += 1
        out = fn(*args, **kwargs)
        kept.append(out)
        return out

    setattr(obj, name, counted)
    return counter, kept


def trainer_launches(tag, counters, steps, evals):
    """The counts a run of ``steps`` training steps and ``evals``
    evaluation batches must show, every K2 and K3 launch on the Hopper
    kernels."""
    return expect_launches(tag, counters, K1=evals, K2=36 * steps + 18 * evals,
                           K2_wgrad=18 * steps, K3=18 * evals,
                           K3_train=18 * steps)


def read_csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def rel_param_errs(torch, got, ref):
    """Each parameter's ‖got − ref‖ / ‖ref‖ (0 where both are 0)."""
    out = {}
    for n, r in ref.items():
        d, norm = float((got[n].float() - r.float()).norm()), float(
            r.float().norm())
        out[n] = d / norm if norm > 0 else (0.0 if d == 0 else math.inf)
    return out


def trainer_phase(torch, dev, flagship):
    """The port's ``Trainer`` on the card at full width (the flagship
    ``ExperimentConfig()``, B=8, 50 frames of 126×224 content, bf16) over a
    stand-in dataset: 2 epochs with the cascade inside each, a resume for a
    third, ``test()``; launch counts, artifacts, the loop against
    ``make_train_step`` driven directly, the resume against an
    uninterrupted run (and two faulty resumes), ``from_checkpoint`` against
    ``test()``, the sensor branch, timing; then the GRU's float32 pin under
    torch's default cuDNN flags."""
    import shutil
    import tempfile

    import numpy as np

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.train import (
        Trainer, create_train_state, make_train_step)
    from vision_collision_detection_tpu_torch.train import (
        trainer as trainer_mod)

    cfg = ExperimentConfig().override({"train.validation_freq": 2,
                                       "train.checkpoint_every_epochs": 1})
    n_train, n_val, n_test = TRAINER_CLIPS
    T = cfg.data.num_frames
    clips, labels, _ = trainer_data(torch, n_train + n_val + n_test, 16, T)
    parts = np.split(np.arange(len(clips)), [n_train, n_train + n_val])
    train_ds, val_ds, test_ds = (
        StandInClips(clips[p], TRAINER_BROKEN if k == 0 else None,
                     labels=labels[p])
        for k, p in enumerate(parts))
    report = {"config": {"clips": TRAINER_CLIPS, "broken": TRAINER_BROKEN,
                         "validation_freq": 2, "checkpoint_every_epochs": 1}}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        # ---- the run: 2 epochs, a resumed third, test ----
        counters = zero_counters()
        tr = Trainer(cfg, train_ds, val_ds, test_ds, run_dir=run_dir)
        init = {k: v.clone() for k, v in tr.model.state_dict().items()}
        evals, _ = count_calls(tr, "eval_step")
        _, step_out = count_calls(tr, "train_step")
        t0 = time.perf_counter()
        tr.train(epochs=2)
        torch.cuda.synchronize()
        two_epochs_s = time.perf_counter() - t0
        # (the steps counted as calls: ``train`` ends by reloading ``best``,
        # whose step count may be an earlier one)
        launches = [trainer_launches("trainer 2 epochs", counters,
                                     len(step_out), evals[0])]
        start = tr.store.load("last", map_location=dev)[0]["model"]
        for fault in ("moments_dropped", "step_restarted"):
            shutil.copytree(tr.store.path("last"),
                            os.path.join(tmp, fault, "last"))
        resume_cfg = cfg.override({"train.resume": True})
        counters = zero_counters()
        tr2 = Trainer(resume_cfg, train_ds, val_ds, test_ds, run_dir=run_dir)
        if (tr2.start_epoch, tr2.state.step) != (2, 4):
            raise SystemExit(f"trainer: resumed at epoch {tr2.start_epoch}, "
                             f"step {tr2.state.step}; expected 2 and 4")
        evals2, _ = count_calls(tr2, "eval_step")
        steps2, _ = count_calls(tr2, "train_step")
        tr2.train(epochs=3)
        torch.cuda.synchronize()
        launches.append(trainer_launches("trainer resumed epoch", counters,
                                         steps2[0], evals2[0]))
        counters = zero_counters()
        test_res = tr2.test()
        torch.cuda.synchronize()
        launches.append(trainer_launches("trainer test", counters, 0, 1))
        total = {k: sum(d[k] for d in launches) for k in launches[0]}
        report["launches"] = total
        report["two_epochs_s"] = two_epochs_s

        # ---- artifacts, parsed without pandas ----
        hist = read_csv_rows(os.path.join(run_dir, "training_history.csv"))
        vals = []
        for e in range(3):
            with open(os.path.join(run_dir, f"validation_epoch{e}.json")) as f:
                vals.append(json.load(f))
        with open(os.path.join(run_dir, "test_results.json")) as f:
            test_json = json.load(f)
        preds = read_csv_rows(os.path.join(run_dir, "test_predictions.csv"))
        roles = sorted(n for n in os.listdir(run_dir)
                       if tr2.store.exists(n))
        ok = ([int(r["epoch"]) for r in hist] == [0, 1, 2]
              and all(math.isfinite(float(r["train_loss"])) for r in hist)
              and all(v["num_samples"] == n_val for v in vals)
              and test_json["num_samples"] == n_test and len(preds) == n_test
              and list(preds[0]) == ["id", "target", "predicted",
                                     "prob_normal", "prob_near_collision",
                                     "prob_collision", "correct"]
              and roles == ["best", "epoch_0", "epoch_1", "epoch_2", "last"])
        log(f"[trainer] 2 epochs in {two_epochs_s:.2f} s, then epoch 3 "
            f"resumed and test(): history {[(r['epoch'], r['train_loss'], r['val_loss']) for r in hist]}; "
            f"roles {roles}; test accuracy {test_json['accuracy']:.3f}")
        if not ok:
            raise SystemExit(f"trainer: artifacts wrong: {hist} {roles} "
                             f"{test_json} {preds[:1]}")
        report["history"] = hist

        # ---- the loop against make_train_step driven directly ----
        model, state = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.train.seed),
            tr.steps_per_epoch, device=dev)
        same_init = all(torch.equal(v, init[k])
                        for k, v in model.state_dict().items())
        step = make_train_step(model, cfg, train_ds.class_weights())
        tr.train_loader.set_epoch(0)
        direct = []
        for i, b in enumerate(tr.train_loader):
            gen = torch.Generator(device=dev).manual_seed(
                trainer_mod.step_seed(cfg.train.seed, 0, i))
            mask = (~(b["error"] | b["pad"])).astype(np.float32)
            _, m = step(state, torch.from_numpy(b["frames"]).to(dev),
                        torch.from_numpy(b["target"]).to(dev),
                        torch.from_numpy(mask).to(dev), gen)
            direct.append(float(m["loss"]))
        looped = [float(m["loss"]) for _, m in step_out[:len(direct)]]
        loop_err = max(abs(a - b) / abs(b) for a, b in zip(looped, direct))
        log(f"[trainer] epoch 0's steps, loop {looped} against "
            f"make_train_step driven directly {direct}: relative "
            f"{loop_err:.2e} ({'bit-equal' if looped == direct else 'within ' + str(TRAIN_TOL) if loop_err <= TRAIN_TOL else 'OUTSIDE'}); "
            f"the same initial weights: {same_init}")
        if not same_init or loop_err > TRAIN_TOL:
            raise SystemExit("trainer: the loop disagrees with the step")
        report["loop_vs_step"] = {"loop": looped, "direct": direct,
                                  "rel_err": loop_err,
                                  "bit_equal": looped == direct}
        del model, state, step

        # ---- resume against an uninterrupted run; faulty resumes ----
        whole = Trainer(cfg, train_ds, val_ds, run_dir=os.path.join(
            tmp, "whole"))
        # its epoch checkpoints kept in device memory, not on the disk
        kept = {}
        whole.store.save_epoch = lambda epoch, arrays, meta: kept.update(
            {epoch: {k: v.clone() for k, v in arrays["model"].items()}})
        whole.train(epochs=3)
        ref_last, ref_start = kept[2], kept[1]
        shutil.rmtree(whole.run_dir)
        ref_update = {k: ref_last[k].float() - ref_start[k].float()
                      for k in ref_last}

        def update_errs(run):
            got = last_model(run, dev)
            upd = {k: got[k].float() - start[k].float() for k in got}
            errs = rel_param_errs(torch, upd, ref_update)
            return max(errs.values()), got

        resumed_update, resumed_last = update_errs(run_dir)
        param_err = max(rel_param_errs(torch, resumed_last, ref_last).values())
        loss_err = max(
            abs(float(a[k]) - float(b[k])) / abs(float(b[k]))
            for a, b in zip(hist, whole.history.records)
            for k in ("train_loss", "val_loss"))
        restore = Trainer._restore_arrays

        def moments_dropped(self, arrays):
            opt = arrays["optimizer"]
            restore(self, dict(arrays, optimizer={
                "state": {}, "param_groups": opt["param_groups"]}))

        def step_restarted(self, arrays):
            restore(self, dict(arrays, step=0))

        faults = {}
        for name, fn in (("moments_dropped", moments_dropped),
                         ("step_restarted", step_restarted)):
            with swapped((Trainer, "_restore_arrays", fn)):
                ftr = Trainer(resume_cfg, train_ds, val_ds,
                              run_dir=os.path.join(tmp, name))
            ftr.train(epochs=3)
            faults[name] = update_errs(ftr.run_dir)[0]
            shutil.rmtree(ftr.run_dir)
            del ftr
        log(f"[trainer] resumed epoch 3 against an uninterrupted run: "
            f"losses relative {loss_err:.2e}, parameters relative to their "
            f"norm {param_err:.2e}, epoch 3's update relative to the "
            f"uninterrupted one's {resumed_update:.2e} (tol {TRAIN_TOL:.0e}); "
            f"faulty resumes, the update: "
            + ", ".join(f"{k} {v:.2e}" for k, v in faults.items()))
        if max(loss_err, param_err, resumed_update) > TRAIN_TOL:
            raise SystemExit("trainer: the resumed run disagrees with the "
                             "uninterrupted one")
        if not all(v > TRAIN_TOL for v in faults.values()):
            raise SystemExit(f"trainer: a faulty resume was not seen: {faults}")
        report["resume"] = {"loss_rel_err": loss_err,
                            "param_rel_err": param_err,
                            "update_rel_err": resumed_update,
                            "faults_update_rel_err": faults}
        del whole, ref_last, ref_start, ref_update, resumed_last

        # ---- serving from the trainer's checkpoint ----
        pred = CollisionPredictor.from_checkpoint(run_dir)
        batch = next(iter(tr2.test_loader))
        probs = pred._make_forward(False)(batch["frames"]).cpu().numpy()
        serve_err = float(np.abs(probs - test_res["_probs"]).max())
        log(f"[trainer] from_checkpoint(run dir) loads "
            f"{tr2.store.latest_role()!r}: max |Δprob| against test()'s "
            f"{serve_err:.3e} (bit-equal required)")
        if not np.array_equal(probs, test_res["_probs"]):
            raise SystemExit("trainer: from_checkpoint disagrees with test()")
        report["from_checkpoint_max_abs_err"] = serve_err
        del pred, tr, tr2
        torch.cuda.empty_cache()

        report["timing"] = time_trainer_loop(torch, dev, cfg, clips[:n_train],
                                             labels[:n_train], val_ds, tmp)
    report["sensor"] = trainer_sensor_step(torch, dev, cfg, val_ds)
    report["gru_pin"] = gru_pin_phase(torch, dev, flagship)
    return report


def last_model(run_dir, dev):
    """The model of a run directory's ``last`` checkpoint."""
    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore

    return CheckpointStore(run_dir).load("last", map_location=dev)[0]["model"]


def time_trainer_loop(torch, dev, cfg, clips, labels, val_ds, tmp):
    """The Trainer's loop over TRAINER_TIME_STEPS steps (the stand-in
    serving its 16 clips again, no validation inside) against the same
    steps of ``make_train_step`` fed batches already on the card, in turns
    on the host clock (median of 3 each); the loop's idle share under
    torch.profiler, the pinned copy of one batch, one checkpoint save, one
    evaluation batch and the loop's peak memory."""
    import numpy as np

    from vision_collision_detection_tpu_torch.ckpt.checkpoint import (
        ARRAYS_FILE)
    from vision_collision_detection_tpu_torch.train import Trainer
    from vision_collision_detection_tpu_torch.train import (
        trainer as trainer_mod)

    B = cfg.data.batch_size
    long_ds = StandInClips(clips, TRAINER_BROKEN,
                           length=B * TRAINER_TIME_STEPS, labels=labels)
    tt = Trainer(cfg.override({"train.validation_freq": 0}), long_ds, val_ds,
                 run_dir=os.path.join(tmp, "timing"))
    tt.train_loader.set_epoch(0)
    batches = []
    for b in tt.train_loader:
        mask = (~(b["error"] | b["pad"])).astype(np.float32)
        batches.append(tuple(torch.from_numpy(a).to(dev) for a in (
            b["frames"], b["target"], mask)))
    gen = torch.Generator(device=dev)
    seed = tt.cfg.train.seed

    def loop():
        tt._train_epoch(0)

    def steps():
        for i, (f, t, m) in enumerate(batches):
            gen.manual_seed(trainer_mod.step_seed(seed, 0, i))
            tt.train_step(tt.state, f, t, m, gen)

    variants = {"loop": loop, "steps": steps}
    rounds = {k: [] for k in variants}
    loop()  # warm-up: the first epoch builds the feed's pinned buffers
    steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for order in (["loop", "steps"], ["steps", "loop"], ["loop", "steps"]):
        for k in order:
            rounds[k].append(median_step_ms(torch, variants[k], 0, 1))
    peak = torch.cuda.max_memory_allocated()  # over the rounds
    turns = {k: {"ms": statistics.median(v),
                 "ms_per_step": statistics.median(v) / TRAINER_TIME_STEPS,
                 "rounds_ms": v} for k, v in rounds.items()}
    over = turns["loop"]["ms"] / turns["steps"]["ms"] - 1.0
    profile = profile_device(
        torch, "trainer loop", loop, 1,
        {"K2": "dwconv7x7_hopper_kernel",
         "K2 wgrad": "dwconv_wgrad_hopper", "K3 train": "convnext_mlp_wgmma",
         "copy": "Memcpy"})
    pinned = torch.from_numpy(clips[:B]).pin_memory()
    copy_ms = median_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    save_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt._save("last", 0)
        save_s.append(time.perf_counter() - t0)
    size = os.path.getsize(os.path.join(tt.store.path("last"), ARRAYS_FILE))
    eval_ms = median_step_ms(
        torch, lambda: tt.evaluate(tt.val_loader), 1, 3)
    log(f"[trainer time] {TRAINER_TIME_STEPS} steps: the loop "
        f"{turns['loop']['ms_per_step']:.2f} ms a step, make_train_step on "
        f"batches already on the card {turns['steps']['ms_per_step']:.2f} "
        f"(loop over steps {over:+.3f}; rounds {rounds}); peak device "
        f"memory {peak / 1e9:.2f} GB; one batch of {pinned.numel() / 1e6:.1f}"
        f" MB copied pinned in {copy_ms:.3f} ms; a checkpoint save of "
        f"{size / 1e6:.1f} MB (model and AdamW moments) "
        f"{statistics.median(save_s):.3f} s (each {save_s}); evaluate() of "
        f"one batch of 8 {eval_ms:.2f} ms")
    return {"steps": TRAINER_TIME_STEPS, "turns": turns,
            "loop_over_steps": over, "peak_mem_bytes": peak,
            "idle_share": profile["idle_share"] if profile else None,
            "profile": profile, "batch_bytes": pinned.numel(),
            "copy_ms": copy_ms, "save_s": statistics.median(save_s),
            "save_rounds_s": save_s, "checkpoint_bytes": size,
            "evaluate_one_batch_ms": eval_ms}


def trainer_sensor_step(torch, dev, cfg, val_ds):
    """One Trainer step of the flagship with ``model.use_sensor`` on, on a
    seeded non-zero sensor stream [8, 50, 4]: launch counts, finite and
    non-zero gradients for ``sensor_fc1``/``sensor_fc2``, and the same
    step on plain versions within TRAIN_TOL."""
    import copy as copy_mod
    import tempfile

    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.train import Trainer

    clips, labels, imu = trainer_data(torch, cfg.data.batch_size, 17,
                                      cfg.data.num_frames, sensor=True)
    ds = StandInClips(clips, None, labels=labels, sensor=imu)
    with tempfile.TemporaryDirectory() as tmp:
        ts = Trainer(cfg.override({"model.use_sensor": True,
                                   "train.validation_freq": 0}), ds, val_ds,
                     run_dir=tmp)
        init = {k: v.clone() for k, v in ts.model.state_dict().items()}
        opt0 = copy_mod.deepcopy(ts.state.optimizer.state_dict())

        def one_step():
            ts.model.load_state_dict(init)
            ts.state.optimizer.load_state_dict(opt0)
            ts.state.step = 0
            loss = ts._train_epoch(0)["loss"]
            return loss, {n: p.grad.detach().float().clone()
                          for n, p in ts.model.named_parameters()}

        counters = zero_counters()
        loss, grads = one_step()
        launches = trainer_launches("trainer sensor step", counters, 1, 0)
        plain = ((k2, "_launch_fwd", k2.dwconv7x7_plain),
                 (k2, "_launch_wgrad", k2.dwconv7x7_wgrad_plain),
                 (k3, "_launch_train", k3.convnext_mlp_train_plain))
        with swapped(*plain):
            plain_loss, plain_grads = one_step()
    sensor = {n: float(g.abs().max()) for n, g in grads.items()
              if n.startswith("sensor_fc")}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    loss_err = abs(loss - plain_loss) / abs(plain_loss)
    errs = rel_grad_errs(torch, grads, plain_grads)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"[trainer sensor] one step with use_sensor: loss {loss:.6f} (plain "
        f"{plain_loss:.6f}, relative {loss_err:.2e}); largest |grad| of the "
        f"sensor layers {sensor}; worst gradient errors against plain "
        f"{[(n, f'{e:.2e}') for n, e in worst]} (tol {TRAIN_TOL:.0e})")
    if len(sensor) != 4 or not finite or min(sensor.values()) == 0:
        raise SystemExit("trainer sensor: a sensor gradient is missing, "
                         "non-finite or zero")
    if loss_err > TRAIN_TOL or worst[0][1] > TRAIN_TOL:
        raise SystemExit("trainer sensor: the step disagrees with its plain "
                         "version")
    return {"launches": launches, "loss": loss, "plain_loss": plain_loss,
            "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
            "sensor_grad_max_abs": sensor}


def _cudnn_flags(torch):
    """cuDNN's TF32 flags as torch reports them: the legacy switch (or
    "mixed" where its getter raises) and, where torch has them, the conv
    and RNN precisions."""
    c = torch.backends.cudnn
    try:
        legacy = c.allow_tf32
    except RuntimeError:
        legacy = "mixed"
    per_op = ((c.conv.fp32_precision, c.rnn.fp32_precision)
              if hasattr(c, "rnn") else None)
    return legacy, per_op


def gru_pin_phase(torch, dev, flagship):
    """Under torch's default cuDNN flags (TF32 on; set for this phase only
    and put back after it): the flagship GRU head (phase 3's weights) on
    seeded features [8, 25, 768], pinned and unpinned, against a float64
    copy on the CPU, output and weight gradients; the caller's flags
    before and after; then phase 3's B=8 serving forward under the
    defaults against the same forward under this script's switch, which
    must be bit-equal (else the first module whose output differs is
    named)."""
    import torch.nn.functional as F

    cudnn = torch.backends.cudnn
    pred, frames = flagship["pred"], flagship["frames"]
    head = pred.model.temporal
    H = head.hidden
    g = torch.Generator().manual_seed(18)
    feats = torch.randn(8, 25, 768, generator=g)
    ref = copy.deepcopy(head).cpu().double()

    def unpinned(module):
        """The head's forward without the pin (and without its float32
        cast, so that the float64 copy stays float64)."""
        def fn(x):
            out, _ = module.gru(x)
            last = torch.cat([out[:, -1, :H], out[:, 0, H:]], dim=-1)
            return F.relu(module.proj(last))
        return fn

    def run(fn, module, x):
        """Output and GRU weight gradients of ``fn`` on ``x``; the module
        in train mode meanwhile (cuDNN's RNN backward needs it; the GRU
        has no dropout, so its output is the same)."""
        x = x.clone().requires_grad_(True)
        module.train()
        try:
            y = fn(x)
            y.square().sum().backward()
        finally:
            module.eval()
        grads = {n: p.grad.detach().double().cpu().clone()
                 for n, p in module.gru.named_parameters()}
        for p in module.parameters():
            p.grad = None
        return y.detach().double().cpu(), grads

    want, want_g = run(unpinned(ref), ref, feats.double())
    cudnn.allow_tf32 = True
    try:
        before = _cudnn_flags(torch)
        with torch.enable_grad():
            x = feats.to(dev).requires_grad_(True)
            head.train()
            out, _ = head.gru(x)
            head.eval()
            node = type(out.grad_fn).__name__  # the node the pin hooks
            del out
            got_p, got_pg = run(head, head, feats.to(dev))
            after = _cudnn_flags(torch)
            got_u, got_ug = run(unpinned(head), head, feats.to(dev))
        default_probs = pred._make_forward(True)(frames)
    finally:
        cudnn.allow_tf32 = False
    switch_probs = pred._make_forward(True)(frames)

    def grad_err(gs):
        # the weights: bias_hh's r and z parts are zeroed by the head's
        # hook, which the float64 copy does not carry
        return max(float((gs[n] - w).abs().max() / w.abs().max())
                   for n, w in want_g.items() if n.startswith("weight"))

    errs = {"pinned": float((got_p - want).abs().max()),
            "unpinned": float((got_u - want).abs().max()),
            "pinned_grad_rel": grad_err(got_pg),
            "unpinned_grad_rel": grad_err(got_ug)}
    bit_equal = torch.equal(default_probs, switch_probs)
    differs = None if bit_equal else first_difference(
        torch, pred, frames)
    log(f"[gru pin] torch {torch.__version__}, cuDNN flags under the "
        f"defaults {before}, after the pinned head {after}; the recurrence's "
        f"backward node {node}; the flagship GRU head against float64: "
        f"pinned {errs['pinned']:.3e}, unpinned nn.GRU {errs['unpinned']:.3e}"
        f" (tol {FP32_GRU_TOL:.0e}); weight gradients relative to their "
        f"largest: pinned {errs['pinned_grad_rel']:.3e}, unpinned "
        f"{errs['unpinned_grad_rel']:.3e}; the B=8 serving forward under "
        f"the defaults against this script's switch: "
        f"{'bit-equal' if bit_equal else 'differs, first at ' + str(differs)}")
    if before != after:
        raise SystemExit(f"gru pin: the caller's flags {before} came back as "
                         f"{after}")
    if "CudnnRnn" not in node:
        raise SystemExit(f"gru pin: the GRU's output comes from {node}, not "
                         "from cuDNN's RNN node, so its backward is not pinned")
    if errs["pinned"] > FP32_GRU_TOL or errs["pinned_grad_rel"] > FP32_GRU_TOL:
        raise SystemExit(f"gru pin: the pinned head is not float32: {errs}")
    return {"flags_before": before, "flags_after": after,
            "backward_node": node, "errors": errs, "tol": FP32_GRU_TOL,
            "serving_bit_equal": bit_equal, "first_difference": differs}


# ---- 17. serving a reference checkpoint ------------------------------------

# The float32 reference path's probabilities. On default switches (K2 on
# dwconv.cu, the stock float32 MLP: float32 throughout), against plain
# versions and against the reference module in float64: REF_F64_TOL, as
# the stock blocks are held; the faults must land outside it. With
# ``fused_mlp=True`` (K3 on convnext_mlp.cu), against plain versions:
# phase 3's 2e-2, for the same reason (K3's bf16 roundings of t and h flip
# by 1 ulp where the two sum in another order, and 18 blocks carry the
# flips on: 5.4e-3 on an H100); against float64: K3 rounds t and h to bf16
# (its rule), through 18 blocks (1.7e-2 on this batch on the CPU, where
# the kernels' plain versions run).
REF_TOL = 2e-2
REF_K3_TOL = 5e-2
REF_F64_TOL = 1e-4
REF_LOGIT_STD = 1.5            # the clips' logits' spread, per class


def reference_layout_model(torch):
    """The reference's default architecture (``EnhancedFrameCNN``:
    torchvision's ConvNeXt-tiny without its classifier, a 2-layer
    bidirectional GRU of 512 with its LayerNorm and projection, the
    BatchNorm classifier for 3 classes) in plain torch, with the
    reference's module names, so its ``state_dict`` has the reference's
    keys. Input: normalised frames [B, T, H, W, 3]."""
    nn = torch.nn

    class LayerNorm2d(nn.LayerNorm):
        def forward(self, x):
            x = x.permute(0, 2, 3, 1)
            x = torch.nn.functional.layer_norm(
                x, self.normalized_shape, self.weight, self.bias, self.eps)
            return x.permute(0, 3, 1, 2)

    class Permute(nn.Module):
        def __init__(self, dims):
            super().__init__()
            self.dims = dims

        def forward(self, x):
            return x.permute(self.dims)

    class CNBlock(nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.block = nn.Sequential(
                nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
                Permute([0, 2, 3, 1]), nn.LayerNorm(dim, eps=1e-6),
                nn.Linear(dim, 4 * dim), nn.GELU(), nn.Linear(4 * dim, dim),
                Permute([0, 3, 1, 2]))
            self.layer_scale = nn.Parameter(torch.ones(dim, 1, 1) * 1e-6)

        def forward(self, x):
            return x + self.layer_scale * self.block(x)

    class ConvNeXtTiny(nn.Module):
        def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)):
            super().__init__()
            feats = [nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4),
                                   LayerNorm2d(dims[0], eps=1e-6))]
            for stage in range(4):
                if stage > 0:
                    feats.append(nn.Sequential(
                        LayerNorm2d(dims[stage - 1], eps=1e-6),
                        nn.Conv2d(dims[stage - 1], dims[stage], 2, stride=2)))
                feats.append(nn.Sequential(
                    *[CNBlock(dims[stage]) for _ in range(depths[stage])]))
            self.features = nn.Sequential(*feats)

        def forward(self, x):
            return self.features(x).mean(dim=(2, 3))

    class TemporalRNN(nn.Module):
        def __init__(self, dim=768, hidden=512, layers=2):
            super().__init__()
            self.hidden = hidden
            self.rnn = nn.GRU(dim, hidden, num_layers=layers,
                              batch_first=True, bidirectional=True)
            self.projection = nn.Linear(2 * hidden, dim)
            self.norm = nn.LayerNorm(dim)

        def forward(self, x):
            _, h = self.rnn(self.norm(x))
            last = h[-2:].transpose(0, 1).reshape(-1, 2 * self.hidden)
            return self.projection(last)

    class EnhancedFrameCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = ConvNeXtTiny()
            self.temporal_aggregation = TemporalRNN()
            self.classifier = nn.Sequential(
                nn.Linear(768, 512), nn.BatchNorm1d(512), nn.ReLU(),
                nn.Dropout(0.5), nn.Linear(512, 256), nn.BatchNorm1d(256),
                nn.ReLU(), nn.Dropout(0.5), nn.Linear(256, 3))

        def forward(self, x):
            x = x.permute(0, 1, 4, 2, 3)  # [B, T, 3, H, W]
            if x.shape[1] > 10:
                x = x[:, ::2]
            B, T = x.shape[:2]
            feats = self.backbone(x.reshape(B * T, *x.shape[2:]))
            return self.classifier(
                self.temporal_aggregation(feats.reshape(B, T, -1)))

    return EnhancedFrameCNN()


def distinct_clips(torch, dev, B, T, content):
    """Seeded uint8 clips [B, T, *content, 3] that differ in what they show:
    each a smooth random image (a 4×7 grid of colours, bilinear) under
    noise of ±32 that changes from frame to frame. Clips of noise alone,
    phase 3's, reach the reference model's pooled features nearly alike:
    its LayerNorms take out their levels."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(16)
    coarse = torch.rand(B, 3, 4, 7, generator=g) * 255
    smooth = F.interpolate(coarse, size=content, mode="bilinear",
                           align_corners=False)
    noise = torch.rand(B, T, 3, *content, generator=g) * 64 - 32
    clips = (smooth[:, None] + noise).clamp(0, 255).to(torch.uint8)
    return clips.permute(0, 1, 3, 4, 2).contiguous().to(dev)


def spread_logits(torch, model, fc, x):
    """Rescale the last layer ``fc`` of ``model`` so that its logits on
    ``x`` spread across clips with a standard deviation of REF_LOGIT_STD
    about a mean of 0 (logits a·(z − mean z)): seeded weights leave the
    clips' logits close beside a shift they share, so the probabilities
    sit near one class for every clip, and a comparison of them has little
    power. → a."""
    with torch.no_grad():
        z = model(x).float()
        a = REF_LOGIT_STD / float(z.std(dim=0).mean())
        fc.bias.copy_(a * (fc.bias - z.mean(dim=0)))
        fc.weight.mul_(a)
    return a


def seed_reference_weights(torch, ref, g):
    """Weights of the laws the port's ``init_weights`` draws (flax's:
    kernels N(0, 1/fan_in), here untruncated), biases N(0, 0.1²), norm
    scales 1 + N(0, 0.1²), ConvNeXt layer scales U(0.5, 1.5) (order 1: no
    block an identity), BatchNorm running means N(0, 0.5²) and variances
    U(0.3, 3): torch's own initialisers leave the reference model's output
    almost the same for every clip."""
    nn = torch.nn

    def draw(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                draw(m.weight, m.weight[0].numel() ** -0.5)
                draw(m.bias, 0.1)
            elif isinstance(m, nn.GRU):
                for name, p in m.named_parameters():
                    draw(p, p.shape[1] ** -0.5 if name.startswith("weight")
                         else 0.1)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                draw(m.weight, 0.1, 1.0)
                draw(m.bias, 0.1)
                if isinstance(m, nn.BatchNorm1d):
                    draw(m.running_mean, 0.5)
                    m.running_var.copy_(
                        torch.rand(m.num_features, generator=g) * 2.7 + 0.3)
        for name, p in ref.named_parameters():
            if name.endswith("layer_scale"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)


def reference_phase(torch, dev, frames):
    """A reference-format checkpoint of the reference's default
    architecture (``seed_reference_weights``, ``fc_out`` rescaled so the
    clips' logits spread about 0),
    written on the host and
    served with ``from_torch_checkpoint`` in float32 on the card through
    ``_make_forward(folded_stride=True)`` on seeded uint8 clips of the
    shape of phase 3's batch (50-frame clips decoded at stride 2:
    [8, 25, 126, 224, 3]; ``reference_clips``). Default switches: launches
    K1 1, K2 18 on ``dwconv_hopper.cu``'s float32 route, no K3 (float32
    takes the stock MLP, as the JAX package's default does); against the
    same forward on plain versions and against the reference module in
    float64 on K1's output, both within REF_F64_TOL; the stock blocks
    against float64 under torch's default cuDNN flags and under the
    switch; two faults (the classifier BatchNorm's running variance set to
    1, the GRU's r and z gates swapped). ``fused_mlp=True``: K1 1, K2 18,
    K3 18 on ``convnext_mlp_wgmma.cu``'s float32 route, against plain
    versions and float64 by K3's rule. K2 and K3 on float32 at the stage
    shapes (``f32_kernels``); times of both legs against stock blocks and
    the bfloat16 model, in turns."""
    import shutil
    import tempfile

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.ops import (
        convnext_mlp, dequant_pad, dwconv, preprocess)
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        eval_preprocess)

    frames = distinct_clips(torch, dev, frames.shape[0], frames.shape[1],
                             tuple(frames.shape[2:4]))
    ref = reference_layout_model(torch).eval()
    seed_reference_weights(torch, ref, torch.Generator().manual_seed(17))
    cfg = ExperimentConfig()
    # K1's float32 output, each of the 25 frames twice: the reference
    # module keeps every 2nd of 50
    x = eval_preprocess(frames, cfg.augment, cfg.data.frame_size,
                        torch.float32).repeat_interleave(2, dim=1)
    ref.to(dev)
    a = spread_logits(torch, ref, ref.classifier[8], x)
    ref.cpu()
    log(f"[reference] fc_out rescaled by {a:.3f}")
    hp = {"base_model": "convnext_tiny", "temporal_mode": "gru",
          "num_classes": 3}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def save(name, sd):
            path = os.path.join(tmp, name)
            torch.save({"model_state_dict": sd, "hyperparams": hp}, path)
            return path

        sd = ref.state_dict()
        path = save("reference.pth", sd)
        # phase 22 converts it with the command line
        kept = os.path.join(BUNDLE_DIR, "reference.pth")
        os.makedirs(BUNDLE_DIR, exist_ok=True)
        shutil.copyfile(path, kept)
        t0 = time.perf_counter()
        pred = CollisionPredictor.from_torch_checkpoint(path)
        out["load_s"] = time.perf_counter() - t0
        forward = pred._make_forward(folded_stride=True)
        counters = zero_counters()
        probs = forward(frames)
        torch.cuda.synchronize()
        launches = expect_launches("reference", counters, f32=True,
                                   K1=1, K2=18)
        if tuple(probs.shape) != (frames.shape[0], 3) or not bool(
                torch.isfinite(probs).all()):
            raise SystemExit(f"reference: bad probabilities {probs}")
        spread = float((probs.max(0).values - probs.min(0).values).max())
        log(f"[reference] probs {probs.tolist()}; spread {spread:.4f}; "
            f"loaded in {out['load_s']:.2f} s")
        if spread < SPREAD_MIN:
            raise SystemExit("reference: probabilities too alike")

        plain_swaps = (
            (convnext, "dwconv7x7", dwconv.dwconv7x7_plain),
            (convnext, "convnext_mlp", convnext_mlp.convnext_mlp_plain),
            (preprocess, "dequant_normalize_pad",
             dequant_pad.dequant_normalize_pad_plain))
        with swapped(*plain_swaps):
            plain = pred._make_forward(True)(frames)
        errs = {"kernels_vs_plain": max_err(torch, probs, plain)}

        # fused_mlp=True: K3's float32 route
        fused = CollisionPredictor.from_torch_checkpoint(path, fused_mlp=True)
        fused_fwd = fused._make_forward(True)
        counters = zero_counters()
        probs_fused = fused_fwd(frames)
        torch.cuda.synchronize()
        launches_fused = expect_launches("reference fused_mlp=True", counters,
                                         f32=True, K1=1, K2=18, K3=18)
        with swapped(*plain_swaps):
            plain = fused._make_forward(True)(frames)
        errs["fused_vs_plain"] = max_err(torch, probs_fused, plain)
        del plain

        # the reference module in float64 on K1's output
        ref64 = copy.deepcopy(ref).to(dev).double().eval()
        with torch.no_grad():
            probs64 = torch.softmax(ref64(x.double()), dim=-1).float()
        del ref64, x
        errs["kernels_vs_float64"] = max_err(torch, probs, probs64)
        errs["fused_vs_float64"] = max_err(torch, probs_fused, probs64)
        stock = CollisionPredictor.from_torch_checkpoint(
            path, dwconv_kernel=False, fused_mlp=False)
        stock_fwd = stock._make_forward(True)
        stock_switch = stock_fwd(frames)
        cudnn = torch.backends.cudnn
        cudnn.allow_tf32 = True  # torch's default, for these two calls
        try:
            stock_default = stock_fwd(frames)
            kernels_default = forward(frames)
        finally:
            cudnn.allow_tf32 = False
        errs["stock_vs_float64"] = max_err(torch, stock_switch, probs64)
        errs["stock_defaults_vs_float64"] = max_err(torch, stock_default,
                                                    probs64)
        bit_equal = {"stock": torch.equal(stock_default, stock_switch),
                     "kernels": torch.equal(kernels_default, probs)}

        # faults, each in a checkpoint of its own
        H = 512
        faulty = {}
        bad_bn = dict(sd)
        bad_bn["classifier.1.running_var"] = torch.ones_like(
            sd["classifier.1.running_var"])
        faulty["classifier_bn_var_1"] = bad_bn
        swap_rz = dict(sd)
        for k, v in sd.items():
            if k.startswith("temporal_aggregation.rnn."):
                v = v.clone()
                v[:H], v[H:2 * H] = sd[k][H:2 * H], sd[k][:H]
                swap_rz[k] = v
        faulty["gru_r_z_swapped"] = swap_rz
        seen = {}
        for name, bad in faulty.items():
            fp = CollisionPredictor.from_torch_checkpoint(save(name, bad))
            seen[name] = max_err(torch, fp._make_forward(True)(frames),
                                 probs64)
            del fp

        pred16 = CollisionPredictor.from_torch_checkpoint(path,
                                                          dtype="bfloat16")
        fwd16 = pred16._make_forward(True)
        counters = zero_counters()
        probs16 = fwd16(frames)
        torch.cuda.synchronize()
        launches16 = expect_launches("reference bf16", counters, K1=1,
                                     K2=18, K3=18)
        errs["bf16_vs_float64"] = max_err(torch, probs16, probs64)

    log(f"[reference] max |Δprob|: {errs} (tol: the default forward and "
        f"the stock float32 forward against plain and float64 "
        f"{REF_F64_TOL:.0e}; fused_mlp=True against plain {REF_TOL:.0e}, "
        f"against float64 {REF_K3_TOL:.0e}); under torch's default cuDNN "
        f"flags bit-equal to the switch: {bit_equal}")
    for name, v in seen.items():
        log(f"[reference] with fault {name}: max |Δprob| from float64 "
            f"{v:.3e} (must exceed {REF_F64_TOL:.0e})")
    if not (errs["kernels_vs_plain"] <= REF_F64_TOL
            and errs["kernels_vs_float64"] <= REF_F64_TOL
            and errs["fused_vs_plain"] <= REF_TOL
            and errs["fused_vs_float64"] <= REF_K3_TOL):
        raise SystemExit(f"reference: the forward disagrees: {errs}")
    if not (errs["stock_vs_float64"] <= REF_F64_TOL
            and errs["stock_defaults_vs_float64"] <= REF_F64_TOL
            and all(bit_equal.values())):
        raise SystemExit(f"reference: float32 is not float32 math under "
                         f"the default flags: {errs}, {bit_equal}")
    if not all(v > REF_F64_TOL for v in seen.values()):
        raise SystemExit(f"reference: a fault lands inside: {seen}")
    if not bool(torch.isfinite(probs16).all()):
        raise SystemExit("reference: non-finite bf16 probabilities")

    compare_rows, f32_faults, timing = f32_kernels(torch, dev)
    out["timing"] = in_turns(
        torch, "reference forward",
        {"kernels": lambda: forward(frames),
         "fused_mlp": lambda: fused_fwd(frames),
         "stock": lambda: stock_fwd(frames), "bf16": lambda: fwd16(frames)},
        lambda fn: median_ms(torch, fn, warmup=2, iters=10, queued=False),
        frames.shape[0])
    out.update({"launches": launches, "launches_fused": launches_fused,
                "launches_bf16": launches16,
                "errors": errs, "tol": REF_TOL, "k3_f64_tol": REF_K3_TOL,
                "f64_tol": REF_F64_TOL,
                "defaults_bit_equal": bit_equal, "faults": seen,
                "spread": spread, "compare_rows": compare_rows,
                "compare_faults": f32_faults,
                "kernel_timing": timing,
                "served": {"pth": kept, "frames": frames, "probs": probs}})
    return out


def check_k2_f32(torch, x, w, b, gy, record, faults, failed):
    """K2 on float32 [N, H, W, C] with C a multiple of 32: the Hopper
    kernel bit-equal to ``dwconv.cu`` (the same sum order) and to itself
    over two runs, both within one float32 rounding of the 49-tap sum
    (2^-16 of the largest |output|) of the plain version, and dx (through
    the autograd Function) bit-equal on the two; one channel pair's taps
    swapped in the plain version must land outside. The calls without the
    route forced must take the Hopper kernel."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    shape = list(x.shape)
    before = k2.dwconv7x7.hopper_launches
    got, again = k2.dwconv7x7(x, w, b), k2.dwconv7x7(x, w, b)
    with swapped(old_route(k2)):
        old = k2.dwconv7x7(x, w, b)
    ref = k2.dwconv7x7_plain(x, w, b)
    torch.cuda.synchronize()
    # float32 sums of 49 taps in another order than cuDNN's
    tol = float(ref.abs().max()) * 2 ** -16
    record("K2 (hopper f32)", shape, max_err(torch, got, ref), tol)
    record("K2 (hopper f32) vs dwconv.cu (bit-equal)", shape,
           max_err(torch, got, old), 0.0, entry="K2 (hopper f32)")
    record("K2 (hopper f32) twice (bit-equal)", shape,
           max_err(torch, got, again), 0.0, entry="K2 (hopper f32)")
    record("K2 float32", shape, max_err(torch, old, ref), tol, entry="K2")
    # channels 0 and 1 take each other's taps
    w_bad = w.clone()
    w_bad[:, [0, 1]] = w[:, [1, 0]]
    err = max_err(torch, k2.dwconv7x7_plain(x, w_bad, b), got)
    fault_seen(faults, failed, "K2 (hopper f32) channel pair's taps "
               "swapped", shape, err > tol, max_abs_err=err)
    del got, again, old, ref
    xr = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(k2.dwconv7x7(xr, w, b), xr, gy)
    with swapped(old_route(k2)):
        (dx_old,) = torch.autograd.grad(k2.dwconv7x7(xr, w, b), xr, gy)
    torch.cuda.synchronize()
    record("K2 (hopper f32) dx vs dwconv.cu (bit-equal)", shape,
           max_err(torch, dx, dx_old), 0.0, entry="K2 (hopper f32)")
    if k2.dwconv7x7.hopper_launches - before != 4:  # twice, forward, dx
        failed.append(f"K2 float32 {shape} did not take the Hopper kernel")


def time_k2_f32(torch, x, w, b):
    """One stage's timing rows of K2 on float32: ``K2 (hopper f32)`` and
    ``K2`` (``dwconv.cu`` on the same inputs, the route forced) in turns,
    beside cuDNN's depthwise ``conv2d``, the plain version and the bound
    (x read and out written once in float32: bytes)."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    C, n = x.shape[-1], x.numel()

    def old_call():
        with swapped(old_route(k2)):
            return k2.dwconv7x7(x, w, b)

    new_ms, old_ms = in_turns_ms(torch, lambda: k2.dwconv7x7(x, w, b),
                                 old_call)
    w_cudnn = w.t().reshape(C, 1, 7, 7).contiguous()
    x_cl = x.permute(0, 3, 1, 2)
    bound, by = bound_ms(2 * n * 4 + 50 * C * 4, 98 * n, F32_FLOPS)
    common = {"shape": list(x.shape), "bound_ms": bound, "bound_by": by,
              "plain_ms": median_ms(torch, lambda: k2.dwconv7x7_plain(
                  x, w, b)),
              "library_ms": median_ms(torch, lambda: F.conv2d(
                  x_cl, w_cudnn, b, padding=3, groups=C))}
    return [{"kernel": "K2 (hopper f32)", "ms": new_ms,
             "dwconv_cu_ms": old_ms, **common},
            {"kernel": "K2", "ms": old_ms, **common}]


def check_k3_f32(torch, xs, y, p, record, faults, failed):
    """K3 on float32 [..., C] (erf GELU, the reference's) on its Hopper
    kernel and on ``convnext_mlp.cu`` (the route forced): the eval and
    train variants by K3's rule (2 bf16 ulps at the largest value and a
    mean under 2^-12 of the mean |value|: out, and the train variant's t,
    h_pre and m), train's out bit-equal to eval's; b2 dropped in the plain
    version (out and m) must land outside. The calls without the route
    forced must take the Hopper kernel."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    shape = list(xs.shape)
    before = (k3.convnext_mlp.wgmma_launches,
              k3.convnext_mlp_train.wgmma_launches)
    with torch.no_grad():
        got = k3.convnext_mlp(xs, y, approximate=False, **p)
    train = k3.convnext_mlp_train(xs, y, approximate=False, **p)
    with swapped(old_route(k3)), torch.no_grad():
        old = k3.convnext_mlp(xs, y, approximate=False, **p)
    ref = k3.convnext_mlp_train_plain(xs, y, approximate=False, **p)
    torch.cuda.synchronize()
    tols = {}
    for name, v, r in zip(("out", "t", "h_pre", "m"), (got, *train[1:]),
                          ref):
        tols[name] = (float(r.float().abs().max()) * 2 ** -6,
                      float(r.float().abs().mean()) * 2 ** -12)
        record(f"K3 float32 {name}", shape, max_err(torch, v, r),
               tols[name][0], mean_err(torch, v, r), tols[name][1],
               entry="K3 (wgmma f32)" if name == "out"
               else "K3 train (wgmma f32)")
    record("K3 float32 train out vs eval (bit-equal)", shape,
           max_err(torch, train[0], got), 0.0, entry="K3 train (wgmma f32)")
    record("K3 float32 on convnext_mlp.cu", shape,
           max_err(torch, old, ref[0]), tols["out"][0],
           mean_err(torch, old, ref[0]), tols["out"][1], entry="K3 (f32)")
    fp, _ = K3_FAULTS["b2_dropped"](p, False)
    bad = k3.convnext_mlp_train_plain(xs, y, approximate=False, **fp)
    for name, v, r in (("out", got, bad[0]), ("m", train[3], bad[3])):
        err, mean = max_err(torch, v, r), mean_err(torch, v, r)
        fault_seen(faults, failed, f"K3 float32 b2 dropped ({name})", shape,
                   err > tols[name][0] or mean > tols[name][1],
                   max_abs_err=err, mean_abs_err=mean)
    after = (k3.convnext_mlp.wgmma_launches,
             k3.convnext_mlp_train.wgmma_launches)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        failed.append(f"K3 float32 {shape} did not take the Hopper kernel")


def time_k3_f32(torch, xs, y, p, entries=("K3 (wgmma f32)",
                                           "K3 train (wgmma f32)")):
    """One stage's timing rows of K3 on float32 (erf GELU): ``entries``
    (default ``K3 (wgmma f32)`` and ``K3 train (wgmma f32)``), each in turns
    with
    ``convnext_mlp.cu`` on the same inputs (the route forced; that eval is
    also the row of ``K3 (f32)``), beside the plain versions, the stock
    float32 LN→Linear→GELU→Linear chain and the bounds: x, y read and out
    written in float32 (the train variant also t and m in bf16 and h_pre
    in bf16 at 4C), W1 and W2 in bf16 once; the products take bf16
    operands (K3's rule), at the bf16 peak."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    C, n = xs.shape[-1], xs.numel()
    M = n // C
    flops = 16 * M * C * C
    kb, kby = bound_ms(3 * n * 4 + 8 * C * C * 2, flops, BF16_FLOPS)
    kb_t, kby_t = bound_ms(3 * n * 4 + 12 * n + 8 * C * C * 2, flops,
                           BF16_FLOPS)
    w1t, w2t = p["w1"].t().contiguous(), p["w2"].t().contiguous()

    def stock():
        t = F.layer_norm(y, (C,), p["ln_w"], p["ln_b"], 1e-6)
        h = F.gelu(F.linear(t, w1t, p["b1"]))
        return xs + F.linear(h, w2t, p["b2"]) * p["gamma"]

    def call(fn, *route):
        def run():
            with swapped(*route), torch.no_grad():
                return fn(xs, y, approximate=False, **p)
        return run

    new_ms, old_ms = in_turns_ms(torch, call(k3.convnext_mlp),
                                 call(k3.convnext_mlp, old_route(k3)))
    new_t, old_t = in_turns_ms(torch, call(k3.convnext_mlp_train),
                               call(k3.convnext_mlp_train, old_route(k3)))
    stock_ms = median_ms(torch, stock)
    plain = median_ms(torch, call(k3.convnext_mlp_plain))
    plain_t = median_ms(torch, call(k3.convnext_mlp_train_plain))
    common = {"shape": list(xs.shape), "library_ms": None}
    return [{"kernel": entries[0], "ms": new_ms, "mma_sync_ms": old_ms,
             "plain_ms": plain, "stock_chain_ms": stock_ms, "bound_ms": kb,
             "bound_by": kby, **common},
            {"kernel": "K3 (f32)", "ms": old_ms, "plain_ms": plain,
             "stock_chain_ms": stock_ms, "bound_ms": kb, "bound_by": kby,
             **common},
            {"kernel": entries[1], "ms": new_t,
             "mma_sync_ms": old_t, "plain_ms": plain_t, "bound_ms": kb_t,
             "bound_by": kby_t, **common}]


def log_f32_timing(timing):
    for r in timing:
        extra = {k: r[k] for k in ("dwconv_cu_ms", "dwconv_wgrad_cu_ms",
                                   "mma_sync_ms", "stock_chain_ms")
                 if k in r}
        log(f"[time f32] {r['kernel']} {r['shape']} "
            f"x{r.get('per_forward', 1)}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}; plain "
            f"{r['plain_ms']:.4f}; library {r['library_ms']}; {extra})")


def f32_kernels(torch, dev):
    """K2 and K3 on float32 activations at the four stage shapes of the
    reference ConvNeXt's serving forward, on their Hopper routes
    (``dwconv_hopper.cu``, ``convnext_mlp_wgmma.cu``) and on the kernels
    they replaced on that path (``dwconv.cu``, ``convnext_mlp.cu``, the
    route forced): ``check_k2_f32`` and ``check_k3_f32``, then each kernel
    timed in turns with the one it replaced on the same inputs (new, old,
    old, new), beside its plain version, cuDNN's depthwise conv (K2) and
    the stock float32 chain (K3): ``time_k2_f32``, ``time_k3_f32``."""
    g = torch.Generator().manual_seed(19)
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    timing = []
    for H, C, blocks in STAGES:
        shape = (N_FRAMES, H, H, C)
        x = torch.randn(shape, generator=g).to(dev)
        w = (torch.randn(49, C, generator=g) / 7).to(dev)
        b = (torch.randn(C, generator=g) * 0.1).to(dev)
        gy = torch.randn(shape, generator=g).to(dev)
        check_k2_f32(torch, x, w, b, gy, record, faults, failed)
        del gy
        stage = time_k2_f32(torch, x, w, b)
        xs = torch.randn(shape, generator=g).to(dev)
        p = k3_params(torch, C, g, dev)
        check_k3_f32(torch, xs, x, p, record, faults, failed)
        stage += time_k3_f32(torch, xs, x, p)
        timing += [dict(r, per_forward=blocks) for r in stage]
        del x, xs
        torch.cuda.empty_cache()
    log_f32_timing(timing)
    if failed:
        raise SystemExit(f"float32 kernels disagree: {failed}")
    return rows, faults, timing


# ---- 25. float32 training: the kernels -------------------------------------

# K2 wgrad on float32 beyond the stages: an odd shape on the Hopper route,
# and a width of 40 (no multiple of 32), which stays on dwconv_wgrad.cu.
K2_WGRAD_F32_ODD = ((64, 10, 6, 96), (64, 14, 14, 40))
F32_K3_ROWS = N_FRAMES * 7 * 7    # ConvNeXt base's and large's last stage


def time_k2_wgrad_f32(torch, x, gy):
    """One stage's timing row of K2 wgrad on float32: ``K2 wgrad (hopper
    f32)`` in turns with ``dwconv_wgrad.cu`` on the same inputs (the route
    forced, ``dwconv_wgrad_cu_ms``), beside the plain version, cuDNN's
    float32 depthwise weight and bias gradient (``convolution_backward``
    on channels_last views, TF32 off) and the bound: x and g read once in
    float32, dw written, 98 flops per element (bytes)."""
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    C, n = x.shape[-1], x.numel()

    def old_call():
        with swapped((k2, "wgrad_route", lambda dtype, C_: "tile")):
            return k2.dwconv7x7_wgrad(x, gy)

    new_ms, old_ms = in_turns_ms(torch, lambda: k2.dwconv7x7_wgrad(x, gy),
                                 old_call)
    x_cl, gy_cl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    w_cudnn = torch.zeros(C, 1, 7, 7, dtype=x.dtype, device=x.device)
    bound, by = bound_ms(2 * n * 4 + 49 * C * 4, 98 * n, F32_FLOPS)
    return {"kernel": "K2 wgrad (hopper f32)", "shape": list(x.shape),
            "ms": new_ms, "dwconv_wgrad_cu_ms": old_ms,
            "plain_ms": median_ms(torch, lambda: k2.dwconv7x7_wgrad_plain(
                x, gy), warmup=1, iters=3),
            "library_ms": median_ms(
                torch, lambda: torch.ops.aten.convolution_backward(
                    gy_cl, x_cl, w_cudnn, [C], [1, 1], [3, 3], [1, 1], False,
                    [0, 0], C, [False, True, True])),
            "bound_ms": bound, "bound_by": by}


def time_k3_wide_f32(torch, xs, y, p):
    """The timing rows of K3 on float32 at a split-kernel width (erf GELU):
    ``K3 (wide f32)`` and ``K3 train (wide f32)``, each in turns with
    ``convnext_mlp.cu`` on the same inputs (the route forced,
    ``mma_sync_ms``), beside the plain versions, the stock float32
    LN→Linear→GELU→Linear chain and the bounds (x, y read and out written
    in float32, the train variant also t and m in bf16 and h_pre in bf16
    at 4C, W1 and W2 in bf16 once; the products on bf16 operands at the
    bf16 peak: operations)."""
    rows = time_k3_f32(torch, xs, y, p, entries=("K3 (wide f32)",
                                                 "K3 train (wide f32)"))
    return [r for r in rows if r["kernel"] != "K3 (f32)"]


def f32_train_kernels(torch, dev):
    """Phase 25's kernel checks, the float32 routes a float32 model's
    training step and ConvNeXt base's and large's float32 forward take. K2
    wgrad on float32 at the four stage shapes on its Hopper route and on
    ``dwconv_wgrad.cu`` (the route forced), each against its plain version
    relative to Σ|x·g| and bit-equal over two runs, with flipped and
    swapped taps outside, each stage timed (``time_k2_wgrad_f32``); then
    an odd shape and a width of 40 (``dwconv_wgrad.cu``, its route). K3 on
    float32 at [9800, 1024] and [9800, 1536] on the split kernel: eval and
    train by K3's rule with its faults (``check_k3_small``), twice
    bit-equal and stage by stage (``check_k3_wide``), timed
    (``time_k3_wide_f32``; ``convnext_mlp.cu`` on the same inputs is held
    in phase 2 with the route forced). → (rows, faults, timing)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    g = torch.Generator(device=dev).manual_seed(25)
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    timing = []
    for H, C, blocks in STAGES:
        shape = (N_FRAMES, H, H, C)
        x = torch.randn(shape, generator=g, device=dev)
        gy = torch.randn(shape, generator=g, device=dev)
        log(f"[f32 wgrad] {list(shape)}: geometry "
            f"{k2.wgrad_hopper_geometry(*shape, dtype=torch.float32)}")
        check_k2_wgrad(torch, x, gy, record, failed, faults)
        with swapped((k2, "wgrad_route", lambda dtype, C_: "tile")):
            check_k2_wgrad(torch, x, gy, record, failed)
        timing.append(dict(time_k2_wgrad_f32(torch, x, gy),
                           per_forward=blocks))
        del x, gy
    for shape in K2_WGRAD_F32_ODD:
        x = torch.randn(shape, generator=g, device=dev)
        gy = torch.randn(shape, generator=g, device=dev)
        check_k2_wgrad(torch, x, gy, record, failed, faults)
        del x, gy
    for C in k3.WIDE_DIMS:
        before = (k3.convnext_mlp.wide_launches,
                  k3.convnext_mlp_train.wide_launches)
        check_k3_small(torch, dev, g, C, F32_K3_ROWS, record, faults, failed,
                       torch.float32)
        check_k3_wide(torch, dev, g, C, F32_K3_ROWS, record, failed,
                      torch.float32)
        # check_k3_small's two GELU forms and check_k3_wide's two calls of
        # each variant
        rise = (k3.convnext_mlp.wide_launches - before[0],
                k3.convnext_mlp_train.wide_launches - before[1])
        if rise != (4, 4):
            failed.append(f"K3 float32 at {C} did not take the split kernel: "
                          f"{rise} launches on it, expected (4, 4)")
        xs = torch.randn(F32_K3_ROWS, C, generator=g, device=dev)
        y = torch.randn(F32_K3_ROWS, C, generator=g, device=dev)
        p = k3_params(torch, C, g, dev)
        # W1 and W2 as a block hands them over: transposed views of
        # nn.Linear's float32 storage
        p.update(w1=p["w1"].t().contiguous().t(),
                 w2=p["w2"].t().contiguous().t())
        timing += [dict(r, per_forward=3)
                   for r in time_k3_wide_f32(torch, xs, y, p)]
        del xs, y, p
        torch.cuda.empty_cache()
    log_f32_timing(timing)
    if failed:
        raise SystemExit(f"float32 training kernels disagree: {failed}")
    return rows, faults, timing


# ---- 18. the BatchNorm backbones -------------------------------------------

BN_BACKBONES = ("resnet18", "resnet50", "mobilenet_v2", "mobilenet_v3_small",
                "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l")
BN_STATS_TOL = 1e-5   # the batch's statistics read back from the update
FIXTURE = os.path.join("tests", "fixtures", "pretrained",
                       "mobilenet_v3_small_seeded_fp16.npz")


def bn_backbones_phase(torch, dev, frames):
    """Each BatchNorm backbone with the flagship head in bf16, served on
    phase 3's batch through ``_make_forward(True)`` (K1 once, no other
    kernel): probabilities, ms per batch (median of 10), peak memory. One
    training step of resnet50 + the conv head on a uint8 batch
    [8, 50, 126, 224, 3]: finite loss and gradients, and two BatchNorms'
    running statistics after the step against flax's update recomputed
    from their captured inputs, where torch's unbiased update must land
    outside; ms per step and peak memory. The committed mobilenet_v3_small
    fixture loaded with its ``batch_stats`` and fine-tuned 3 steps."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    out = {"serve": {}}
    launches = {}
    for i, name in enumerate(BN_BACKBONES):
        cfg = ExperimentConfig().override({"model.backbone": name})
        pred = CollisionPredictor(cfg, None)
        redraw_weights(torch, pred.model, torch.Generator().manual_seed(30 + i))
        fwd = pred._make_forward(True)
        counters = zero_counters()
        probs = fwd(frames)
        torch.cuda.synchronize()
        by_entry = expect_launches(f"serve {name}", counters, K1=1)
        launches = {k: launches.get(k, 0) + v for k, v in by_entry.items()}
        row_err = float((probs.sum(-1) - 1).abs().max())
        if not bool(torch.isfinite(probs).all()) or row_err > 1e-5:
            raise SystemExit(f"{name}: bad probabilities {probs}")
        ms = median_ms(torch, lambda: fwd(frames), warmup=2, iters=10,
                       queued=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd(frames)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["serve"][name] = {"ms": ms, "clips_per_s": 8 / ms * 1e3,
                              "peak_mem_bytes": peak,
                              "probs": probs.tolist()}
        log(f"[bn serve] {name}: {ms:.3f} ms per batch of 8, "
            f"{8 / ms * 1e3:.2f} clips/s, peak {peak / 1e9:.2f} GB; probs "
            f"{[round(v, 4) for v in probs[0].tolist()]}...")
        del pred, fwd
        torch.cuda.empty_cache()
    out["train"] = bn_training_step(torch, dev)
    out["fixture"] = bn_fixture(torch, dev)
    out["launches"] = launches
    return out


def bn_training_step(torch, dev):
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    cfg = ExperimentConfig().override({"model.backbone": "resnet50",
                                       "model.temporal_mode": "conv"})
    B, T = cfg.data.batch_size, cfg.data.num_frames
    model, state = create_train_state(cfg, torch.Generator().manual_seed(31),
                                      steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, cfg)
    g = torch.Generator().manual_seed(32)
    frames = torch.randint(0, 256, (B, T, *CONTENT, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    targets = (torch.arange(B) % 3).to(dev)
    mask = torch.ones(B, device=dev)
    layers = {"temporal.bn1": model.temporal.bn1,
              "backbone.layer4_2.bn3": model.backbone.layer4_2.bn3}
    seen, before = {}, {}
    hooks = []
    def capture(name):
        def hook(module, args):  # returns None: the input stays as it is
            seen[name] = args[0].detach().float().clone()
        return hook

    for name, bn in layers.items():
        before[name] = (bn.running_mean.clone(), bn.running_var.clone())
        hooks.append(bn.register_forward_pre_hook(capture(name)))
    counters = zero_counters()
    _, metrics = step(state, frames, targets, mask,
                      torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launches = expect_launches("bn train", counters)
    loss = float(metrics["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    # the conv head's biases feed a BatchNorm: their true gradient is 0
    zero = [n for n, v in grads.items() if float(v.abs().max()) == 0.0
            and not n.startswith("temporal.conv")]
    if not math.isfinite(loss) or bad or zero:
        raise SystemExit(f"bn train: loss {loss}, non-finite {bad}, "
                         f"zero {zero}")
    stats = {}
    for name, bn in layers.items():
        x = seen[name].double()
        n = x.numel() // x.shape[-1]
        dims = tuple(range(x.dim() - 1))
        mean, var = x.mean(dims), x.var(dims, unbiased=False)
        m = bn.momentum
        rm0, rv0 = (t.double() for t in before[name])
        # the batch's statistics the update took in, read back from it
        took_mean = (bn.running_mean.double() - m * rm0) / (1 - m)
        took_var = (bn.running_var.double() - m * rv0) / (1 - m)

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        stats[name] = {"samples": n,
                       "mean_rel_err": rel(took_mean, mean),
                       "var_rel_err": rel(took_var, var),
                       "unbiased_var_rel_err": rel(took_var,
                                                   var * n / (n - 1))}
    log(f"[bn train] resnet50 + conv: loss {loss:.5f}; the update's batch "
        f"statistics against the captured inputs' (tol {BN_STATS_TOL:.0e}; "
        f"torch's unbiased variance must land outside): {stats}")
    if not all(s["mean_rel_err"] <= BN_STATS_TOL
               and s["var_rel_err"] <= BN_STATS_TOL for s in stats.values()):
        raise SystemExit("bn train: the running statistics are not flax's")
    if not stats["temporal.bn1"]["unbiased_var_rel_err"] > BN_STATS_TOL:
        raise SystemExit("bn train: the unbiased update lands inside")
    gen = torch.Generator(device=dev).manual_seed(7)
    ms = median_step_ms(torch, lambda: step(state, frames, targets, mask, gen),
                        warmup=2, iters=TRAIN_TIME_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, frames, targets, mask, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[bn train] {ms:.2f} ms per step of 8 clips, peak {peak / 1e9:.2f} GB")
    del model, state
    torch.cuda.empty_cache()
    return {"launches": launches, "loss": loss, "stats": stats,
            "tol": BN_STATS_TOL, "ms": ms, "peak_mem_bytes": peak}


def bn_fixture(torch, dev):
    import numpy as np

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    path = os.path.join(ROOT, FIXTURE)
    cfg = ExperimentConfig().override({
        "model.backbone": "mobilenet_v3_small",
        "model.temporal_mode": "pooling", "model.pretrained_path": path,
        "model.dropout": 0.0, "optim.learning_rate": 1e-3,
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0})
    model, state = create_train_state(cfg, torch.Generator().manual_seed(33),
                                      steps_per_epoch=STEPS_PER_EPOCH)
    with np.load(path) as z:
        want = torch.from_numpy(z["batch_stats/stem_bn/var"].astype(
            np.float32))
    if not torch.equal(model.backbone.stem_bn.running_var.cpu(), want):
        raise SystemExit("fixture: batch_stats did not load")
    step = make_train_step(model, cfg)
    g = torch.Generator().manual_seed(34)
    frames = torch.randint(0, 256, (8, 50, *CONTENT, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    targets = (torch.arange(8) % 3).to(dev)
    mask = torch.ones(8, device=dev)
    losses = [float(step(state, frames, targets, mask, torch.Generator(
        device=dev).manual_seed(TRAIN_SEED))[1]["loss"]) for _ in range(3)]
    log(f"[bn fixture] mobilenet_v3_small from {FIXTURE}: losses {losses}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"fixture: the loss did not fall: {losses}")
    return {"losses": losses}


# ---- 19. the other heads on the flagship ------------------------------------

HEAD_MODES = ("attention", "conv", "pooling", "rnn", "lstm")
# The heads' serving forward against plain versions: the blocks' bf16
# flips, which reach phase 3's GRU head as up to 9.1e-3, reach the other
# heads, their logits spread by ``spread_logits``, as 1.4e-2 (pooling) to
# 4.3e-2 (rnn) on an H100; a dropped K2 bias lands at 0.25 to 0.73 and must
# land outside.
HEADS_TOL = 1e-1


def heads_phase(torch, dev, frames):
    """ConvNeXt-tiny (bf16, B=8) with each other temporal head: the serving
    forward on seeded clips of the shape of phase 3's batch
    (``distinct_clips``) with ``fc_out`` rescaled so the clips' logits
    spread (``spread_logits``), against the same forward on plain versions
    (HEADS_TOL, where a dropped K2 bias must land outside; launches K1 1,
    K2 18, K3 18 on the Hopper kernels;
    ms per batch, median of 10), and one training step on a uint8 batch
    [8, 50, 126, 224, 3] against the plain step (TRAIN_TOL on the loss and
    on each gradient relative to its norm, gradients under GRAD_FLOOR of the
    global norm held to that floor: the conv head's biases feed a
    BatchNorm and the attention head's key bias shifts every logit alike,
    so their true gradients are 0; launches K2 36, K2 wgrad 18, K3 train
    18)."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import (
        dequant_pad, dwconv, preprocess)
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        eval_preprocess)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    out = {}
    launches = {}

    def add(by_entry):
        for k, v in by_entry.items():
            launches[k] = launches.get(k, 0) + v

    frames = distinct_clips(torch, dev, frames.shape[0], frames.shape[1],
                            tuple(frames.shape[2:4]))
    g = torch.Generator().manual_seed(40)
    train_frames = torch.randint(0, 256, (8, 50, *CONTENT, 3), generator=g,
                                 dtype=torch.uint8).to(dev)
    targets = (torch.arange(8) % 3).to(dev)
    mask = torch.ones(8, device=dev)
    plain_train = ((k2, "_launch_fwd", k2.dwconv7x7_plain),
                   (k2, "_launch_wgrad", k2.dwconv7x7_wgrad_plain),
                   (k3, "_launch_train", k3.convnext_mlp_train_plain))
    for i, mode in enumerate(HEAD_MODES):
        cfg = ExperimentConfig().override({"model.temporal_mode": mode})
        pred = CollisionPredictor(cfg, None)
        redraw_weights(torch, pred.model, torch.Generator().manual_seed(41 + i))
        x = eval_preprocess(frames, cfg.augment, cfg.data.frame_size,
                            torch.bfloat16)
        pred.model.frame_subsample = 1  # x is folded already
        a = spread_logits(torch, pred.model, pred.model.fc_out, x)
        pred.model.frame_subsample = cfg.model.frame_subsample
        del x
        fwd = pred._make_forward(True)
        counters = zero_counters()
        probs = fwd(frames)
        torch.cuda.synchronize()
        add(expect_launches(f"head {mode}", counters, K1=1, K2=18, K3=18))
        def plain_forward(dw=dwconv.dwconv7x7_plain):
            with swapped((convnext, "dwconv7x7", dw),
                         (convnext, "convnext_mlp", k3.convnext_mlp_plain),
                         (preprocess, "dequant_normalize_pad",
                          dequant_pad.dequant_normalize_pad_plain)):
                return pred._make_forward(True)(frames)

        serve_err = max_err(torch, probs, plain_forward())
        # the check's power: K2's bias dropped in the plain version
        fault_err = max_err(torch, probs, plain_forward(
            lambda x, w, b: dwconv.dwconv7x7_plain(x, w, b * 0)))
        spread = float((probs.max(0).values - probs.min(0).values).max())
        ms = median_ms(torch, lambda: fwd(frames), warmup=2, iters=10,
                       queued=False)
        del pred, fwd

        model, state = create_train_state(
            cfg, torch.Generator().manual_seed(50 + i), STEPS_PER_EPOCH)
        step = make_train_step(model, cfg)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        opt_init = copy.deepcopy(state.optimizer.state_dict())

        def run():
            model.load_state_dict(init)
            state.optimizer.load_state_dict(opt_init)
            state.step = 0
            _, m = step(state, train_frames, targets, mask, torch.Generator(
                device=dev).manual_seed(TRAIN_SEED))
            torch.cuda.synchronize()
            return float(m["loss"]), {n: p.grad.detach().float().clone()
                                      for n, p in model.named_parameters()}

        counters = zero_counters()
        loss, grads = run()
        add(expect_launches(f"head {mode} train", counters, K2=36,
                            K2_wgrad=18, K3_train=18))
        with swapped(*plain_train):
            plain_loss, plain_grads = run()
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        errs = rel_grad_errs(torch, grads, plain_grads, floor=GRAD_FLOOR)
        worst = max(errs.items(), key=lambda kv: kv[1])
        bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
        gen = torch.Generator(device=dev).manual_seed(7)
        step_ms = median_step_ms(torch, lambda: step(
            state, train_frames, targets, mask, gen), warmup=1, iters=3)
        out[mode] = {"fc_out_scale": a, "serve_err": serve_err,
                     "serve_tol": HEADS_TOL, "fault_dwconv_bias_dropped":
                     fault_err,
                     "spread": spread, "serve_ms": ms,
                     "loss": loss, "loss_rel_err": loss_err,
                     "worst_grad_rel_err": worst, "step_ms": step_ms}
        log(f"[head {mode}] serving kernels vs plain max |Δprob| "
            f"{serve_err:.3e} (tol {HEADS_TOL:.0e}; K2's bias dropped "
            f"{fault_err:.3e}; spread {spread:.3f}, fc_out rescaled by "
            f"{a:.3f}), {ms:.3f} ms "
            f"per batch; step loss {loss:.5f} vs plain {plain_loss:.5f} "
            f"(rel {loss_err:.2e}), worst gradient {worst[0]} "
            f"{worst[1]:.2e} (tol {TRAIN_TOL:.0e}), {step_ms:.2f} ms per "
            f"step (host clock, median of 3)")
        if serve_err > HEADS_TOL or spread < SPREAD_MIN:
            raise SystemExit(f"head {mode}: serving forward disagrees")
        if not fault_err > HEADS_TOL:
            raise SystemExit(f"head {mode}: the tolerance does not see a "
                             f"dropped bias ({fault_err})")
        if bad or loss_err > TRAIN_TOL or worst[1] > TRAIN_TOL:
            raise SystemExit(f"head {mode}: training step disagrees {bad}")
        del model, state, init, opt_init
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def first_difference(torch, pred, frames):
    """The first module (in call order) of the serving forward whose output
    differs between torch's default cuDNN flags and TF32 off."""
    outs = {}

    def hook(name, store):
        def fn(module, args, out):
            t = out[0] if isinstance(out, tuple) else out
            store.append((name, t.detach().clone()))
        return fn

    for allow in (True, False):
        store = outs[allow] = []
        handles = [m.register_forward_hook(hook(n, store))
                   for n, m in pred.model.named_modules() if n]
        torch.backends.cudnn.allow_tf32 = allow
        try:
            pred._make_forward(True)(frames)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            for h in handles:
                h.remove()
    for (name, a), (_, b) in zip(outs[True], outs[False]):
        if not torch.equal(a, b):
            return name
    return "the classifier MLP or the softmax"


# ---- 20–21. data and tensor parallelism ------------------------------------

# The ranks of phases 20 and 21 are child processes of this script, launched
# with torchrun's variables on a free port (``--rank NAME DIR``); this process
# holds no process group. Two ranks share the one card over gloo, both with
# LOCAL_RANK 0: NCCL refuses two ranks on one device.
RANK_TIMEOUT_S = {"dp_nccl": 240, "dp_gloo": 420, "tp_gloo": 420}
DDP_TIME_ITERS = 5             # phase 20 (a): median of 5 after 2 warm-ups
BN_MEAN_TOL = 1e-6             # phase 20 (c): the statistics' mean
# Phase 21's TP forward against one device's: phase 3's 2e-2, with the head
# scaled by 10 as phase 9 scales it. TP sums each row-parallel product from
# two bf16 partials (as the JAX package's GSPMD does), one bf16 rounding
# more than one device, in 24 products a forward. The training step's model
# scales the head by 3 (the ViViT CPU tests' factor); the forward's error
# with that head is logged beside the bounded one, with no bound.
TP_PROBS_TOL = 2e-2
TP_LOGIT_SCALE = 3.0
# phase 20 (d): per-device batch 4, 16 training clips (2 steps a rank), 8
# validation clips, 7 test clips (one wrap pad, trimmed after the gather)
DP_TRAINER_CLIPS = (16, 8, 7)
DP_TRAINER_BATCH = 4


def run_ranks(name, world, out_dir, backend):
    """``world`` ranks of ``rank_main(name)``, each on card 0 over
    ``backend``; their output is logged. A rank that fails or outlives
    RANK_TIMEOUT_S fails the script; every rank is stopped before this
    returns. → the ranks' results."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), VCD_BACKEND=backend)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", name,
                 out_dir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + RANK_TIMEOUT_S[name]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0])
            except subprocess.TimeoutExpired:
                raise SystemExit(f"{name}: a rank outlived "
                                 f"{RANK_TIMEOUT_S[name]} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"[{name} r{rank}] {line}")
        if p.returncode != 0:
            raise SystemExit(f"{name}: rank {rank} exited {p.returncode}")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{name}_r{rank}.json")) as f:
            results.append(json.load(f))
    return results


def parallel_phases(torch, dev):
    """Phases 20 and 21: the ranks, then what this process checks of their
    checkpoints (``from_checkpoint`` on one card). → (report, launches by
    path, each the sum over the path's ranks)."""
    import tempfile

    t0 = time.time()
    report, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        a, = run_ranks("dp_nccl", 1, tmp, "nccl")
        report["dp_nccl"] = a
        launches["dp_nccl"] = a["launches"]
        b = run_ranks("dp_gloo", 2, tmp, "gloo")
        report["dp_gloo"] = b
        for path in ("dp_step", "dp_bn", "dp_trainer"):
            launches[path] = {k: sum(r["launches"][path][k] for r in b)
                              for k in b[0]["launches"][path]}
        report["dp_trainer_from_checkpoint"] = dp_trainer_served(
            torch, dev, tmp)
        report["phase_20_s"] = time.time() - t0
        t1 = time.time()
        tp = run_ranks("tp_gloo", 2, tmp, "gloo")
        report["tp_gloo"] = tp
        launches["tp_step"] = {k: sum(r["launches"]["tp_step"][k] for r in tp)
                               for k in tp[0]["launches"]["tp_step"]}
        launches["tp_eval"] = {k: sum(r["launches"]["tp_eval"][k] for r in tp)
                               for k in tp[0]["launches"]["tp_eval"]}
        report["tp_from_checkpoint"] = tp_served(torch, dev, tmp)
        report["phase_21_s"] = time.time() - t1
    log(f"[parallel] phase 20 {report['phase_20_s']:.1f} s, phase 21 "
        f"{report['phase_21_s']:.1f} s")
    return report, launches


def rank_main(name, out_dir) -> int:
    """A rank of phase 20 or 21 (``python3 chip_smoke.py --rank NAME DIR``,
    torchrun's variables in the environment): it joins the process group,
    runs its checks (a failed one raises), writes ``NAME_r{rank}.json`` and
    leaves the group."""
    import torch

    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.parallel import (
        maybe_initialize_distributed, sync_global_devices)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(os.environ["VCD_BACKEND"])
    rank = torch.distributed.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    fn = {"dp_nccl": rank_dp_nccl, "dp_gloo": rank_dp_gloo,
          "tp_gloo": rank_tp_gloo}[name]
    out = fn(torch, dev, rank, out_dir)
    with open(os.path.join(out_dir, f"{name}_r{rank}.json"), "w") as f:
        json.dump(out, f)
    sync_global_devices("done")
    torch.distributed.destroy_process_group()
    return 0


def flagship_batch(torch, dev, B, T):
    """Phase 7's seeded uint8 batch [B, T, 126, 224, 3], targets, mask."""
    g = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (B, T, *CONTENT, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    return frames, (torch.arange(B) % 3).to(dev), torch.ones(B, device=dev)


def params_equal(torch, a, b):
    """→ (every parameter bit-equal, the largest |a − b|)."""
    diffs = [float((x.detach().float() - y.detach().float()).abs().max())
             for x, y in zip(a.parameters(), b.parameters())]
    return max(diffs) == 0.0, max(diffs)


def grads_of(torch, model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters()}


def rank_dp_nccl(torch, dev, rank, out_dir):
    """Phase 20 (a), world size 1 over NCCL: the flagship's DP step (DDP,
    the summing hook, the global loss) on uint8 [8, 50, 126, 224, 3]
    against ``make_train_step`` from the same weights and generator; both
    timed in turns; the DP evaluation's gathered probabilities against
    ``make_eval_step``."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_eval_step, make_train_step)

    cfg = ExperimentConfig()
    B, T = cfg.data.batch_size, cfg.data.num_frames

    def fresh():
        return create_train_state(cfg, torch.Generator().manual_seed(3),
                                  steps_per_epoch=STEPS_PER_EPOCH)

    m_dp, s_dp = fresh()
    m_one, s_one = fresh()
    dp = DataParallelStrategy()
    dp_step, dp_eval = dp.make_steps(m_dp, cfg, None)
    one_step = make_train_step(m_one, cfg)
    batch = flagship_batch(torch, dev, B, T)
    init = {k: v.clone() for k, v in m_one.state_dict().items()}

    def gen():
        return torch.Generator(device=dev).manual_seed(TRAIN_SEED)

    counters = zero_counters()
    _, m = dp_step(s_dp, *batch, gen())
    torch.cuda.synchronize()
    launches = expect_launches("dp nccl", counters, K2=36, K2_wgrad=18,
                               K3_train=18)
    _, m1 = one_step(s_one, *batch, gen())
    torch.cuda.synchronize()
    same, diff = params_equal(torch, m_dp, m_one)
    metrics = {k: float(v) for k, v in m.items()}
    metrics_one = {k: float(v) for k, v in m1.items()}
    log(f"DP step (world 1, NCCL) {metrics} against make_train_step "
        f"{metrics_one}: parameters bit-equal {same} (largest |Δ| {diff:.3e})")
    if metrics != metrics_one or not same:
        raise SystemExit("DP at world size 1 is not bit-equal to "
                         "make_train_step")

    times = in_turns(
        torch, "dp nccl", {"make_train_step": lambda: one_step(
            s_one, *batch, gen()), "DP (DDP, world 1)": lambda: dp_step(
                s_dp, *batch, gen())},
        lambda fn: median_step_ms(torch, fn, 2, DDP_TIME_ITERS), B)
    one_ms = times["make_train_step"]["ms"]
    dp_ms = times["DP (DDP, world 1)"]["ms"]
    overhead = (dp_ms - one_ms) / one_ms
    log(f"DDP's overhead at world size 1: {dp_ms:.3f} against {one_ms:.3f} "
        f"ms per step ({100 * overhead:+.2f}%)")

    m_dp.load_state_dict(init)
    m_one.load_state_dict(init)
    probs = dp_eval(*batch)["probs"]
    gathered = dp.gather_eval({"probs": probs.float().cpu().numpy()})["probs"]
    ref = make_eval_step(m_one, cfg)(*batch)["probs"].float().cpu().numpy()
    eval_equal = bool((gathered == ref).all())
    log(f"DP evaluation gathered over NCCL against make_eval_step: "
        f"bit-equal {eval_equal}")
    if not eval_equal:
        raise SystemExit("the DP evaluation disagrees with make_eval_step")
    return {"launches": launches, "metrics": metrics,
            "bit_equal": same, "max_abs_param_diff": diff,
            "times": times, "ddp_overhead": overhead,
            "eval_bit_equal": eval_equal}


def averaging_dp(torch):
    """The fault of phase 20 (b): DDP with its own hook, which averages the
    gradients over the data group where the JAX step sums them."""
    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy)

    class Averaging(DataParallelStrategy):
        def wrap(self, model):
            dev = next(model.parameters()).device
            return torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                process_group=self.mesh.data_group, broadcast_buffers=False)

    return Averaging()


def all_ranks(torch, t):
    """``t`` from every rank, in rank order, on the CPU (gloo)."""
    t = t.detach().float().cpu().contiguous()
    parts = [torch.empty_like(t)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t)
    return parts


def rank_dp_gloo(torch, dev, rank, out_dir):
    """Phase 20 (b)–(d): two ranks sharing the card over gloo."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.models.norm import BatchNorm
    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    out = {"launches": {}}
    dp = DataParallelStrategy()
    n = dp.num_data_shards

    def gen():
        return torch.Generator(device=dev).manual_seed(TRAIN_SEED)

    # ---- (b) the flagship, 4 clips a rank, against one device on all 8;
    # no augmentation or dropout, whose draws follow the batch's size; SGD,
    # since AdamW's first step moves a weight by ±lr whatever its
    # gradient's size, so a near-zero gradient's rounding would decide it
    cfg = ExperimentConfig().override({
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0,
        "model.dropout": 0.0, "optim.optimizer": "sgd"})
    B, T = cfg.data.batch_size, cfg.data.num_frames
    frames, targets, mask = flagship_batch(torch, dev, B, T)
    mine = [t.chunk(n)[rank] for t in (frames, targets, mask)]

    def fresh(c):
        return create_train_state(c, torch.Generator().manual_seed(3),
                                  steps_per_epoch=STEPS_PER_EPOCH)

    model, state = fresh(cfg)
    step, _ = dp.make_steps(model, cfg, None)
    counters = zero_counters()
    _, m = step(state, *mine, gen())
    torch.cuda.synchronize()
    out["launches"]["dp_step"] = expect_launches(
        "dp step", counters, K2=36, K2_wgrad=18, K3_train=18)
    metrics = {k: float(v) for k, v in m.items()}
    grads = grads_of(torch, model)
    params = {n_: p.detach().float().clone()
              for n_, p in model.named_parameters()}
    frozen = {n_: float(p.detach()[: 2 * (p.shape[0] // 3)].abs().max())
              for n_, p in model.named_parameters() if "bias_hh" in n_}
    log(f"(b) DP step {metrics}; the GRU's frozen r/z biases after it "
        f"{frozen}")
    if any(v != 0.0 for v in frozen.values()):
        raise SystemExit("a frozen torch bias moved under DDP")
    out["step_ms"] = median_step_ms(torch, lambda: step(state, *mine, gen()),
                                    1, 3)
    log(f"(b) {out['step_ms']:.3f} ms per DP step, two processes sharing "
        f"one card over gloo (a correctness run, not a DP speed)")
    avg_model, avg_state = fresh(cfg)
    avg_step, _ = averaging_dp(torch).make_steps(avg_model, cfg, None)
    avg_step(avg_state, *mine, gen())
    avg_grads = grads_of(torch, avg_model)
    del avg_model, avg_state, avg_step
    if rank == 0:
        one, one_state = fresh(cfg)
        _, m1 = make_train_step(one, cfg)(one_state, frames, targets, mask,
                                          gen())
        torch.cuda.synchronize()
        loss_err = abs(metrics["loss"] - float(m1["loss"])) / abs(
            float(m1["loss"]))
        gerr = rel_grad_errs(torch, grads, grads_of(torch, one))
        perr = rel_param_errs(torch, params, {
            n_: p.detach() for n_, p in one.named_parameters()})
        fault = rel_grad_errs(torch, avg_grads, grads_of(torch, one))
        worst_g = max(gerr.items(), key=lambda kv: kv[1])
        worst_p = max(perr.items(), key=lambda kv: kv[1])
        least_fault = min(fault.values())
        log(f"(b) 2 ranks against one device on 8: loss rel {loss_err:.2e}, "
            f"worst gradient {worst_g}, worst parameter {worst_p} (tol "
            f"{TRAIN_TOL:.0e}); gradients averaged: least error "
            f"{least_fault:.3e}")
        if max(loss_err, worst_g[1], worst_p[1]) > TRAIN_TOL:
            raise SystemExit("the 2-rank DP step disagrees with one device")
        if not least_fault > TRAIN_TOL:
            raise SystemExit("averaged gradients were not seen")
        out["vs_one_device"] = {"loss_rel_err": loss_err,
                                "worst_grad_rel_err": worst_g,
                                "worst_param_rel_err": worst_p,
                                "averaged_least_grad_rel_err": least_fault,
                                "tol": TRAIN_TOL}
        del one, one_state
    del model, state, step, grads, params, avg_grads
    torch.cuda.empty_cache()

    # ---- (c) resnet18 + the conv head: BatchNorm in both
    bn_cfg = ExperimentConfig().override({"model.backbone": "resnet18",
                                          "model.temporal_mode": "conv"})

    def stats(model_):
        return torch.cat([b.reshape(-1) for m_ in model_.modules()
                          if isinstance(m_, BatchNorm)
                          for b in (m_.running_mean, m_.running_var)])

    model, state = fresh(bn_cfg)
    step, _ = dp.make_steps(model, bn_cfg, None)
    counters = zero_counters()
    step(state, *mine, gen())
    torch.cuda.synchronize()
    out["launches"]["dp_bn"] = expect_launches("dp bn", counters)
    own, own_state = fresh(bn_cfg)
    make_train_step(own, bn_cfg)(own_state, *mine, gen())
    dp_stats = all_ranks(torch, stats(model))
    own_stats = all_ranks(torch, stats(own))
    mean = (own_stats[0] + own_stats[1]) / 2
    bn = {"ranks_bit_equal": bool(torch.equal(dp_stats[0], dp_stats[1])),
          "vs_mean_of_own": float((dp_stats[0] - mean).abs().max()),
          "own_updates_differ_by": float(
              (own_stats[0] - own_stats[1]).abs().max()),
          "n_statistics": int(dp_stats[0].numel()), "tol": BN_MEAN_TOL}
    log(f"(c) resnet18 + conv, running statistics after one DP step: {bn}")
    if not bn["ranks_bit_equal"] or bn["vs_mean_of_own"] > BN_MEAN_TOL:
        raise SystemExit("the BatchNorm statistics are not the ranks' mean")
    if not bn["own_updates_differ_by"] > BN_MEAN_TOL:
        raise SystemExit("without the mean the ranks would agree: the check "
                         "has no power")
    out["bn"] = bn
    del model, state, step, own, own_state
    torch.cuda.empty_cache()

    # ---- (d) the Trainer
    trainer = dp_trainer_rank(torch, dev, rank, out_dir, dp)
    out["launches"]["dp_trainer"] = trainer.pop("launches")
    out.update(trainer)
    return out


def dp_trainer_data(torch):
    """Phase 20 (d)'s stand-in datasets (phase 16's clips, seeded)."""
    import numpy as np

    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    T = ExperimentConfig().data.num_frames
    clips, labels, _ = trainer_data(torch, sum(DP_TRAINER_CLIPS), 16, T)
    n_train, n_val, _ = DP_TRAINER_CLIPS
    parts = np.split(np.arange(len(clips)), [n_train, n_train + n_val])
    return [StandInClips(clips[p], TRAINER_BROKEN if k == 0 else None,
                         labels=labels[p]) for k, p in enumerate(parts)]


def dp_trainer_cfg():
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().override({
        "data.batch_size": DP_TRAINER_BATCH, "train.epochs": 1,
        "train.validation_freq": 0, "train.checkpoint_every_epochs": 0,
        "train.dashboard": False})


def dp_trainer_rank(torch, dev, rank, out_dir, dp):
    """Phase 20 (d) on a rank: ``Trainer`` with ``DataParallelStrategy``,
    one epoch of 2 steps, the validation gather, ``test()``; the checkpoint
    files this rank wrote, counted."""
    from vision_collision_detection_tpu_torch.train import Trainer

    train_ds, val_ds, test_ds = dp_trainer_data(torch)
    run_dir = os.path.join(out_dir, "dp_run")
    writes, save = [0], torch.save

    def counted_save(*args, **kwargs):
        writes[0] += 1
        return save(*args, **kwargs)

    counters = zero_counters()
    tr = Trainer(dp_trainer_cfg(), train_ds, val_ds, test_ds,
                 run_dir=run_dir, strategy=dp)
    evals, _ = count_calls(tr, "eval_step")
    step_fn, step_ms = tr.train_step, []

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step_fn(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    tr.train_step = timed_step
    with swapped((torch, "save", counted_save)):
        tr.train()
        res = tr.test()
    torch.cuda.synchronize()
    launches = trainer_launches("dp trainer", counters, len(step_ms),
                                evals[0])
    roles = sorted(r for r in ("best", "last") if tr.store.exists(r))
    out = {"launches": launches, "trainer": {
        "steps": len(step_ms), "step_ms": step_ms, "eval_batches": evals[0],
        "num_samples": int(res["num_samples"]), "loss": float(res["loss"]),
        "ids": list(res["ids"]), "checkpoint_writes": writes[0],
        "roles": roles}}
    log(f"(d) Trainer: {out['trainer']} (ms per step: two processes "
        f"sharing one card)")
    want_writes = 2 if rank == 0 else 0
    if (len(step_ms) != 2 or res["num_samples"] != DP_TRAINER_CLIPS[2]
            or roles != ["best", "last"] or writes[0] != want_writes
            or len(set(res["ids"])) != DP_TRAINER_CLIPS[2]):
        raise SystemExit(f"(d) the DP Trainer run is not as expected: "
                         f"{out['trainer']}")
    if rank == 0:
        torch.save({"probs": torch.from_numpy(res["_probs"])},
                   os.path.join(out_dir, "dp_test_probs.pt"))
    return out


def dp_trainer_served(torch, dev, tmp):
    """Phase 20 (d) on one card: ``from_checkpoint`` of the DP run serves
    each rank's test batch as the ranks did (4 clips, the wrap pad after
    the last); the pads dropped, bit-equal to rank 0's ``test()``."""
    import numpy as np

    from vision_collision_detection_tpu_torch.data.loader import ClipLoader
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    cfg = dp_trainer_cfg()
    _, _, test_ds = dp_trainer_data(torch)
    pred = CollisionPredictor.from_checkpoint(os.path.join(tmp, "dp_run"))
    forward = pred._make_forward(False)
    probs, pads = [], []
    for shard in range(2):
        loader = ClipLoader(test_ds, DP_TRAINER_BATCH, num_workers=1,
                            seed=cfg.data.seed, mask_wrap=True, num_shards=2,
                            shard_index=shard, pad_partial=True)
        for batch in loader:
            probs.append(forward(batch["frames"]).float().cpu().numpy())
            pads.append(batch["pad"])
    probs = np.concatenate(probs)[~np.concatenate(pads)]
    want = torch.load(os.path.join(tmp, "dp_test_probs.pt"))["probs"].numpy()
    err = float(np.abs(probs - want).max())
    log(f"[dp trainer] from_checkpoint on one card against rank 0's test(): "
        f"max |Δprob| {err:.3e} (bit-equal required)")
    if not np.array_equal(probs, want):
        raise SystemExit("from_checkpoint of the DP run disagrees with test()")
    del pred
    torch.cuda.empty_cache()
    return {"max_abs_err": err}


def vivit_noise_batch(torch, dev, T, B, seed, content=VIVIT_CONTENT):
    """Phase 11's ViViT batch: noise frames, each of its own brightness."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randint(48, 208, (B, T, *content, 3), generator=g,
                          dtype=torch.int16)
    level = torch.randint(-48, 48, (B, T, 1, 1, 1), generator=g,
                          dtype=torch.int16)
    return ((noise + level).to(torch.uint8).to(dev),
            (torch.arange(B) % 3).to(dev), torch.ones(B, device=dev))


def tp_model(torch, cfg):
    """The scaled ViViT with phase 11's seeded weights, every bias and
    LayerNorm redrawn and the head scaled (as phase 3), so that a dropped
    or doubled bias shows and the probabilities spread."""
    from vision_collision_detection_tpu_torch.train import create_train_state

    model, state = create_train_state(cfg, torch.Generator().manual_seed(13),
                                      steps_per_epoch=STEPS_PER_EPOCH)
    g = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g)
                               * 0.1)
        model.head.weight.mul_(TP_LOGIT_SCALE)
    return model, state


def rank_tp_gloo(torch, dev, rank, out_dir):
    """Phase 21: the scaled ViViT over a model group of 2 (two ranks
    sharing the card over gloo), B=8: one TP step against one device's
    (rank 0), with K4 on 3 of the 6 heads a rank; the out projection's bias
    added on both ranks as the fault; the TP forward against one device's;
    the gathered weights saved for ``from_checkpoint``."""
    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore
    from vision_collision_detection_tpu_torch.config import MeshConfig
    from vision_collision_detection_tpu_torch.ops.flash_attention import (
        FlashSelfAttention)
    from vision_collision_detection_tpu_torch.parallel import (
        ModelParallelStrategy, create_mesh)
    from vision_collision_detection_tpu_torch.parallel.tp import (
        full_state_dict, shard_state_dict)
    from vision_collision_detection_tpu_torch.train import (
        make_eval_step, make_train_step)

    cfg = vivit_cfg()
    T = cfg.data.num_frames
    tp = ModelParallelStrategy(create_mesh(MeshConfig(num_model=2)))
    model, state = tp_model(torch, cfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = tp.shard_state(model, state)
    local = tuple(model.spatial_0.attn.query.weight.shape)
    step, eval_step = tp.make_steps(model, cfg, None)
    batch = vivit_noise_batch(torch, dev, T, VIVIT_BATCH, 14)
    opt0 = copy.deepcopy(state.optimizer.state_dict())

    def gen():
        return torch.Generator(device=dev).manual_seed(TRAIN_SEED)

    def tp_shards(sd):
        return shard_state_dict(sd, tp.rules, tp.mesh.model_index, 2)

    def run():
        """One TP step from the initial weights; → metrics, the gradients
        gathered."""
        model.load_state_dict(tp_shards(init))
        state.optimizer.load_state_dict(opt0)
        state.step = 0
        _, m = step(state, *batch, gen())
        torch.cuda.synchronize()
        g_ = full_state_dict({n_: p.grad for n_, p in
                              model.named_parameters()}, tp.rules,
                             tp.mesh.model_group, 2)
        return {k: float(v) for k, v in m.items()}, {
            k: v.float() for k, v in g_.items()}

    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    t0 = time.perf_counter()
    metrics, grads = run()
    step_s = time.perf_counter() - t0
    launches = {"tp_step": expect_launches(
        "tp step", counters, K4_fwd=VIVIT_BLOCKS, K4_bwd_dKdV=VIVIT_BLOCKS,
        K4_bwd_dQ=VIVIT_BLOCKS, K4_bwd_di=VIVIT_BLOCKS, train_preprocess=2)}
    peak = torch.cuda.max_memory_allocated()
    log(f"TP step {metrics} in {step_s:.2f} s (the first, over gloo); the "
        f"query weight cut to {local}; peak memory {peak / 1e9:.2f} GB")

    def bias_before_sum(self, o):
        B_, S_ = o.shape[:2]
        return self.tp.exit(torch.nn.functional.linear(
            o.reshape(B_, S_, -1), self.out.weight.to(self.dtype),
            self.out.bias.to(self.dtype)))

    with swapped((FlashSelfAttention, "project_out", bias_before_sum)):
        fault_metrics, fault_grads = run()

    # the forward: the TP evaluation of the initial weights
    model.load_state_dict(tp_shards(init))
    counters = zero_counters()
    probs = eval_step(*batch)["probs"].float()
    torch.cuda.synchronize()
    launches["tp_eval"] = expect_launches("tp eval", counters, K1=1,
                                          K4_fwd=VIVIT_BLOCKS)
    with torch.no_grad():  # the head as phase 9 scales it
        model.head.weight.mul_(LOGIT_SCALE / TP_LOGIT_SCALE)
    probs_x10 = eval_step(*batch)["probs"].float()
    model.load_state_dict(tp_shards(init))
    full_sd, opt_sd = tp.full_state(model, state.optimizer)
    CheckpointStore(os.path.join(out_dir, "tp_run")).save(
        "best", arrays={"model": full_sd, "optimizer": opt_sd, "step": 0},
        meta={"epoch": 0, "hyperparams": cfg.to_dict()})
    out = {"launches": launches, "local_query": local, "metrics": metrics,
           "first_step_s": step_s, "peak_mem_bytes": peak, "batch":
           VIVIT_BATCH}
    if rank == 0:
        one, one_state = tp_model(torch, cfg)
        one_step = make_train_step(one, cfg)
        _, m1 = one_step(one_state, *batch, gen())
        torch.cuda.synchronize()
        one_grads = grads_of(torch, one)
        loss_err = abs(metrics["loss"] - float(m1["loss"])) / abs(
            float(m1["loss"]))

        def verdict(errs):
            loose = {n_: e for n_, e in errs.items()
                     if n_.startswith("temporal_") and (
                         ".attn.query." in n_ or ".attn.key." in n_)}
            rest = max(((n_, e) for n_, e in errs.items() if n_ not in loose),
                       key=lambda kv: kv[1])
            return max(loose.items(), key=lambda kv: kv[1]), rest

        loose, rest = verdict(rel_grad_errs(torch, grads, one_grads,
                                            GRAD_FLOOR))
        f_loss = abs(fault_metrics["loss"] - float(m1["loss"])) / abs(
            float(m1["loss"]))
        f_loose, f_rest = verdict(rel_grad_errs(torch, fault_grads,
                                                one_grads, GRAD_FLOOR))
        log(f"TP step against one device: loss rel {loss_err:.2e}, worst "
            f"temporal query/key {loose} (tol {VIVIT_TEMPORAL_QK_TOL:.0e}), "
            f"worst other {rest} (tol {VIVIT_TRAIN_TOL:.0e}); the out bias "
            f"added on both ranks: loss rel {f_loss:.2e}, worst other "
            f"{f_rest}")
        if (loss_err > VIVIT_TRAIN_TOL or rest[1] > VIVIT_TRAIN_TOL
                or loose[1] > VIVIT_TEMPORAL_QK_TOL):
            raise SystemExit("the TP step disagrees with one device")
        if not max(f_loss, f_rest[1]) > VIVIT_TRAIN_TOL:
            raise SystemExit("the doubled out bias was not seen")
        one.load_state_dict(init)
        one_eval = make_eval_step(one, cfg)
        def spread_of(p):
            return float((p.max(0).values - p.min(0).values).max())

        ref = one_eval(*batch)["probs"].float()
        err, spread = float((probs - ref).abs().max()), spread_of(ref)
        with torch.no_grad():
            one.head.weight.mul_(LOGIT_SCALE / TP_LOGIT_SCALE)
        ref = one_eval(*batch)["probs"].float()
        err_x10 = float((probs_x10 - ref).abs().max())
        spread_x10 = spread_of(ref)
        one.load_state_dict(full_sd)
        gathered = one_eval(*batch)["probs"].float().cpu()
        torch.save({"probs": gathered},
                   os.path.join(out_dir, "tp_gathered_probs.pt"))
        log(f"TP forward against one device, with phase 9's "
            f"×{LOGIT_SCALE:g} head: max |Δprob| {err_x10:.3e} (tol "
            f"{TP_PROBS_TOL:.0e}; the probabilities spread "
            f"{spread_x10:.3f}); with the step's ×{TP_LOGIT_SCALE:g} head "
            f"{err:.3e} (no bound; spread {spread:.3f})")
        if err_x10 > TP_PROBS_TOL:
            raise SystemExit("the TP forward disagrees with one device")
        out["vs_one_device"] = {
            "loss_rel_err": loss_err, "worst_temporal_qk": loose,
            "worst_other": rest, "fault_loss_rel_err": f_loss,
            "fault_worst_other": f_rest, "probs_max_abs_err": err,
            "probs_spread": spread, "probs_max_abs_err_head_x10": err_x10,
            "probs_spread_head_x10": spread_x10}
    return out


def tp_served(torch, dev, tmp):
    """Phase 21 on one card: ``from_checkpoint`` of the gathered TP weights
    bit-equal to one device's forward of them."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    cfg = vivit_cfg()
    frames = vivit_noise_batch(torch, dev, cfg.data.num_frames, VIVIT_BATCH,
                               14)[0]
    pred = CollisionPredictor.from_checkpoint(os.path.join(tmp, "tp_run"))
    probs = pred._make_forward(False)(frames).float().cpu()
    want = torch.load(os.path.join(tmp, "tp_gathered_probs.pt"))["probs"]
    err = float((probs - want).abs().max())
    log(f"[tp] from_checkpoint of the gathered weights on one card: max "
        f"|Δprob| {err:.3e} against their forward (bit-equal required)")
    if not torch.equal(probs, want):
        raise SystemExit("from_checkpoint of the TP run disagrees")
    del pred
    torch.cuda.empty_cache()
    return {"max_abs_err": err}


# ---- 22. serving bundles and the command line ------------------------------

BUNDLE_DIR = os.path.join(ROOT, "build", "chip_smoke_bundles")
FLAGSHIP_BUCKETS = (1, 8, 32)
VIVIT_BUCKETS = (1, 8)
BUNDLE_TOL = 1e-6              # a bundle against the forward it exports
BUNDLE_SPEED_BAND = 0.05       # bucket 8 against the forward: reported


def served_like_bundle(torch, forward, buckets, clips):
    """``forward`` over ``clips`` cut and zero-padded as ``ServingBundle``
    does: the smallest bucket that holds what remains, else the largest."""
    out, i, n = [], 0, clips.shape[0]
    while i < n:
        bucket = next((b for b in buckets if b >= n - i), buckets[-1])
        take = min(n - i, bucket)
        batch = torch.zeros((bucket, *clips.shape[1:]), dtype=torch.uint8,
                            device=clips.device)
        batch[:take] = clips[i:i + take]
        out.append(forward(batch)[:take])
        i += take
    return torch.cat(out)


# A serving host's cold start, in a fresh process: imports, then (the
# card's context made and the batch on it first) for a bundle the import of
# torch.export's loader, then the bundle or the checkpoint loaded and its
# first call, each on the host's clock; cold_s is all but the imports.
COLD_START = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
mode, path, frames_path, folded, out = sys.argv[1:6]
if mode == "bundle":
    from vision_collision_detection_tpu_torch.infer import ServingBundle
else:
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
got = {"import_s": time.perf_counter() - t0, "loader_import_s": 0.0}
frames = torch.load(frames_path).cuda()
torch.cuda.synchronize()
t0 = time.perf_counter()
if mode == "bundle":
    import torch._export.serde.serialize  # what torch.export.load imports
    got["loader_import_s"] = time.perf_counter() - t0
    bundle = ServingBundle(path)
    got["load_s"] = time.perf_counter() - t0 - got["loader_import_s"]
    probs = bundle.run(frames)
else:
    pred = CollisionPredictor.from_checkpoint(path)
    got["load_s"] = time.perf_counter() - t0
    probs = pred._make_forward(folded == "1")(frames)
torch.cuda.synchronize()
got["cold_s"] = time.perf_counter() - t0
got["first_call_s"] = got["cold_s"] - got["loader_import_s"] - got["load_s"]
got["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
torch.save(probs.cpu(), out + ".pt")
json.dump(got, open(out, "w"))
"""


def cold_start(torch, mode, path, frames_path, folded, want):
    """``COLD_START`` in a child process; its probabilities must agree with
    ``want`` within BUNDLE_TOL."""
    out = os.path.join(BUNDLE_DIR, f"cold_{mode}.json")
    proc = subprocess.run(
        [sys.executable, "-c", COLD_START, mode, path, frames_path,
         "1" if folded else "0", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"cold start ({mode}) failed: {proc.stderr[-2000:]}")
    with open(out) as f:
        got = json.load(f)
    probs = torch.load(out + ".pt")
    got["max_abs_err"] = max_err(torch, probs, want.cpu())
    got["bit_equal"] = torch.equal(probs, want.cpu())
    if not got["max_abs_err"] <= BUNDLE_TOL:
        raise SystemExit(f"cold start ({mode}): other probabilities")
    return got


def bundle_phase(torch, dev, flagship, vivit, reference):
    """Phase 22: phase 3's flagship predictor (content 126×224, buckets 1,
    8, 32) and phase 10's scaled ViViT (buckets 1, 8) exported as serving
    bundles under ``build/`` (one program with a dynamic batch) and
    reloaded by ``ServingBundle``: export and save s and ``.pt2`` bytes;
    cold start in a fresh process each (``ServingBundle`` and the first
    bucket-8 call, against ``from_checkpoint`` and the first forward;
    ``COLD_START``); at each bucket the program against ``_make_forward``
    on the same batch (BUNDLE_TOL), a 9-clip request as the bundle cuts
    it; launches of one bucket-8 call (K1 1, K2 18, K3 18; K1 1, K4 8; all
    on the Hopper kernels); the flagship program run without the bundle's
    pin under torch's default cuDNN flags (the GRU in TF32) must land
    outside BUNDLE_TOL, and with it bit-equal; ms per call at bucket 8
    against ``_make_forward`` in turns; the flagship forward, whose kernel
    calls go through their ``torch.library`` ops, against the same forward
    with the ops swapped for their implementations, in turns (the
    dispatch's cost; the training step enters no op). Then
    ``cli.convert_weights --full`` on phase 17's ``.pth`` in a child
    process, its ``.npz`` pair served by ``from_torch_checkpoint``
    bit-equal to phase 17's probabilities."""
    import shutil

    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore
    from vision_collision_detection_tpu_torch.infer import (
        ServingBundle, aot, export_bundle)
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.ops import library

    out, launches = {}, {}
    cases = (("flagship", flagship, FLAGSHIP_BUCKETS, CONTENT, True,
              dict(K1=1, K2=18, K3=18)),
             ("vivit", vivit, VIVIT_BUCKETS, VIVIT_CONTENT, False,
              dict(K1=1, K4_fwd=VIVIT_BLOCKS)))
    for tag, serve, buckets, box, folded, expected in cases:
        pred, frames = serve["pred"], serve["frames"]
        forward = pred._make_forward(folded)
        path = os.path.join(BUNDLE_DIR, tag)
        times = {}
        real_export, real_save = torch.export.export, torch.export.save

        def timed_export(*a, **k):
            t0 = time.perf_counter()
            program = real_export(*a, **k)
            times["export_s"] = time.perf_counter() - t0
            return program

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            real_save(*a, **k)
            times["save_s"] = time.perf_counter() - t0

        with swapped((torch.export, "export", timed_export),
                     (torch.export, "save", timed_save)):
            manifest = export_bundle(pred, path, buckets, content_box=box)
        if manifest["platforms"] != [dev.type] or manifest["buckets"] != list(
                buckets):
            raise SystemExit(f"bundle {tag}: manifest {manifest}")
        times["bytes"] = os.path.getsize(os.path.join(path, aot.PROGRAM))
        log(f"[bundle {tag}] exported {times}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = ServingBundle(path)
        load_s = time.perf_counter() - t0
        first = bundle.run(frames)
        torch.cuda.synchronize()

        # cold start: a fresh process each for the bundle and for a
        # checkpoint of the same weights
        run = os.path.join(BUNDLE_DIR, f"{tag}_run")
        CheckpointStore(run).save(
            "best", arrays={"model": pred.model.state_dict()},
            meta={"hyperparams": pred.cfg.to_dict()})
        frames_path = os.path.join(BUNDLE_DIR, f"{tag}_frames.pt")
        torch.save(frames.cpu(), frames_path)
        cold = {"bundle": cold_start(torch, "bundle", path, frames_path,
                                     folded, first),
                "checkpoint": cold_start(torch, "checkpoint", run,
                                         frames_path, folded, first)}
        shutil.rmtree(run)
        log(f"[bundle {tag}] cold start in a fresh process (s): "
            f"{cold}; ServingBundle in this process {load_s:.3f} s")

        # agreement at each bucket and on a 9-clip request
        batches = {1: frames[:1], 8: frames,
                   32: torch.cat([frames, frames.flip(1), 255 - frames,
                                  frames.flip(3)])}
        errs, equal = {}, {}
        for B in buckets:
            got, want = bundle.run(batches[B]), forward(batches[B])
            errs[B], equal[B] = max_err(torch, got, want), torch.equal(
                got, want)
        request = torch.cat([frames, frames[:1].flip(2)])
        got = torch.from_numpy(bundle.predict_probs(request))
        want = served_like_bundle(torch, forward, buckets, request).cpu()
        errs["request_9"], equal["request_9"] = max_err(
            torch, got, want), torch.equal(got, want)
        log(f"[bundle {tag}] against _make_forward: max |Δprob| {errs} "
            f"(tol {BUNDLE_TOL:.0e}); bit-equal {equal}")
        if not all(v <= BUNDLE_TOL for v in errs.values()):
            raise SystemExit(f"bundle {tag} disagrees with the forward")

        counters = zero_counters()
        bundle.run(frames)
        torch.cuda.synchronize()
        launches[f"bundle_{tag}"] = expect_launches(f"bundle {tag}",
                                                    counters, **expected)

        entry = {"program": times, "load_s": load_s, "cold_start": cold,
                 "max_abs_err": errs, "bit_equal": equal,
                 "launches": launches[f"bundle_{tag}"]}
        if tag == "flagship":
            # the exported graph holds no cuDNN flag: the pin is the
            # bundle's (run() enters Float32Pin around every call)
            cudnn = torch.backends.cudnn
            cudnn.allow_tf32 = True  # torch's default, for these two calls
            try:
                pinned = bundle.run(frames)
                with torch.inference_mode():
                    unpinned = bundle._program(frames)
            finally:
                cudnn.allow_tf32 = False
            fault = max_err(torch, unpinned, first)
            log(f"[bundle {tag}] under torch's default flags: pinned "
                f"bit-equal {torch.equal(pinned, first)}; the pin removed "
                f"(GRU in TF32): max |Δprob| {fault:.3e} (must exceed "
                f"{BUNDLE_TOL:.0e})")
            if not torch.equal(pinned, first) or not fault > BUNDLE_TOL:
                raise SystemExit("bundle: the float32 pin does not hold")
            entry["unpinned_fault_max_abs_err"] = fault

            def straight():
                with swapped(
                        (library, "dequant_pad", library._k1._run),
                        (library, "dwconv7x7", library._k2._forward),
                        (library, "convnext_mlp", library._k3._eval)):
                    return forward(frames)

            if not torch.equal(straight(), forward(frames)):
                raise SystemExit("the forward without its ops differs")
            entry["dispatch_ab"] = in_turns(
                torch, "dispatch A/B", {"straight": straight,
                                        "through_ops": lambda: forward(
                                            frames)},
                lambda fn: median_ms(torch, fn, warmup=2, iters=10,
                                     queued=False), frames.shape[0])
            d = entry["dispatch_ab"]
            entry["dispatch_cost"] = (d["through_ops"]["ms"]
                                      / d["straight"]["ms"] - 1)
            log(f"[dispatch A/B] the forward through the ops: "
                f"{entry['dispatch_cost']:+.2%} of straight calls")

        speed = in_turns(
            torch, f"bundle {tag} speed",
            {"bundle": lambda: bundle.run(frames),
             "forward": lambda: forward(frames)},
            lambda fn: median_ms(torch, fn, warmup=2, iters=10,
                                 queued=False), frames.shape[0])
        ratio = speed["bundle"]["ms"] / speed["forward"]["ms"] - 1
        band = "within" if abs(ratio) <= BUNDLE_SPEED_BAND else "OUTSIDE"
        log(f"[bundle {tag}] bucket 8: {speed['bundle']['ms']:.3f} ms "
            f"against the forward's {speed['forward']['ms']:.3f} "
            f"({ratio:+.2%}; {band} ±{BUNDLE_SPEED_BAND:.0%})")
        entry.update(speed=speed, bundle_vs_forward=ratio)
        out[tag] = entry
        del bundle, first
        torch.cuda.empty_cache()

    # the command line: phase 17's .pth through convert_weights --full
    npz = os.path.join(BUNDLE_DIR, "reference.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "vision_collision_detection_tpu_torch.cli.convert_weights",
         "--torch-checkpoint", reference["pth"], "--full", "--output", npz],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True)
    convert_s = time.perf_counter() - t0
    if proc.returncode:
        raise SystemExit(f"convert_weights failed: {proc.stderr[-2000:]}")
    pred = CollisionPredictor.from_torch_checkpoint(npz)
    probs = pred._make_forward(True)(reference["frames"])
    torch.cuda.synchronize()
    err = max_err(torch, probs, reference["probs"])
    log(f"[cli] {proc.stdout.strip()} in {convert_s:.2f} s; its .npz pair "
        f"served against the .pth: max |Δprob| {err:.3e} (bit-equal "
        f"required)")
    if not torch.equal(probs, reference["probs"]):
        raise SystemExit("convert_weights --full: the .npz serves otherwise")
    out["convert_weights"] = {"s": convert_s, "max_abs_err": err}
    del pred
    shutil.rmtree(BUNDLE_DIR)
    torch.cuda.empty_cache()
    return out, launches


# ---- 23. the attention view and the launcher ---------------------------------

# Phase 23 (a): ``extract_attention_weights`` on the kernels against the
# same call on plain versions, absolute: the per-frame importance [8, 25]
# (ATTN_TOL) and the full matrix [8, 4, 25, 25] (ATTN_FULL_TOL). The
# blocks' bf16 flips move the head's input, and the attention logits,
# spread to a standard deviation of ATTN_LOGIT_STD over the keys, carry
# them into the weights. On an H100 at std 3 they read 1.116e-2 per frame
# and 6.811e-2 on the full matrix (the same in two calls); at std 2, 5 and
# 8: 9.5e-3, 1.47e-2, 3.30e-2 per frame, the spread growing more slowly.
ATTN_TOL = 1.5e-2
ATTN_FULL_TOL = 1e-1
ATTN_LOGIT_STD = 3.0           # of the attention logits over the keys
ATTN_SPREAD_MIN = 10 * ATTN_TOL  # least max − min over T of any clip's importance
ATTN_ROW_TOL = 1e-5            # every row of the matrix sums to 1
ATTN_TIME_BAND = 0.03          # the view against the forward: predicted
ATTN_SEED = 41                 # phase 19's attention model (redraw_weights)
LAUNCHER_BATCH = 8             # run_training_torch.sh's default BATCH_SIZE

# A PYTHON for scripts/run_training_torch.sh that runs ``-c`` with the real
# interpreter (the device count) and records every other call's arguments.
LAUNCHER_STUB = """#!/bin/sh
if [ "$1" = "-c" ]; then exec "$VCD_REAL_PYTHON" "$@"; fi
printf '%s\\n' "$*" >> "$VCD_STUB_LOG"
"""


def frame_clips(torch, dev, B, T, content, seed):
    """Seeded uint8 clips [B, T, *content, 3] whose every frame shows its own
    smooth random image under noise (``distinct_clips`` per frame), so that
    the frames' features differ and the attention has something to weigh."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(B * T, 3, 4, 7, generator=g) * 255
    smooth = F.interpolate(coarse, size=content, mode="bilinear",
                           align_corners=False)
    noise = torch.rand(B * T, 3, *content, generator=g) * 64 - 32
    clips = (smooth + noise).clamp(0, 255).to(torch.uint8)
    return clips.permute(0, 2, 3, 1).reshape(B, T, *content, 3).contiguous(
        ).to(dev)


def spread_attention(torch, model, x):
    """Scale the attention head's query and key projections (weights and
    biases) by s, so that the attention logits on ``x`` have a standard
    deviation over the keys of ATTN_LOGIT_STD (the logits scale by s²):
    seeded weights leave them close to uniform, and the importance of each
    frame nearly flat. → s."""
    from vision_collision_detection_tpu_torch.models import temporal

    head = model.temporal
    seen = []
    hook = head.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(x)
    finally:
        hook.remove()
    feats = seen[0]
    B, T, D = feats.shape
    H = head.num_heads
    with torch.no_grad():
        h = feats.to(head.dtype) + head.pos_embedding[:T].to(head.dtype)

        def heads(fc):
            return temporal.linear(h, fc, head.dtype).reshape(
                B, T, H, D // H).transpose(1, 2).float()

        logits = heads(head.query) @ heads(head.key).transpose(-1, -2)
        logits = logits / math.sqrt(D // H)
        std = float(logits.std(dim=-1).mean())
        s = math.sqrt(ATTN_LOGIT_STD / std)
        for fc in (head.query, head.key):
            fc.weight.mul_(s)
            fc.bias.mul_(s)
    return s


def attention_view_phase(torch, dev):
    """Phase 23: ConvNeXt-tiny + the attention head (4 heads) + MLP, bf16,
    phase 19's attention model (seed ATTN_SEED), its query and key scaled
    by ``spread_attention``, on seeded uint8 clips [8, 25, 126, 224, 3]
    (``frame_clips``) through eval preprocessing (K1) and
    ``obs.viz.extract_attention_weights``: launches K1 1, K2 18, K3 18 on
    the Hopper kernels and nothing else; the logits bit-equal to
    ``model(x)``; rows summing to 1 (ATTN_ROW_TOL); the per-frame form the
    full matrix's mean over heads and queries; both against the same call
    on plain versions (ATTN_TOL per frame, ATTN_FULL_TOL on the matrix),
    where the matrix of the previous call on another batch and the mean
    over keys (1/T) must land outside, and each clip's importance must
    spread across frames (ATTN_SPREAD_MIN). The view
    against the forward in turns; the overlay's frames on clip 0. The
    MP4s, HTML and PNG where FFmpeg and matplotlib are installed. (b) The
    launcher's ``distributed 4`` through a recording PYTHON, and its
    ``check`` where FFmpeg is installed."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.obs import viz
    from vision_collision_detection_tpu_torch.ops import (
        convnext_mlp, dequant_pad, dwconv, preprocess)
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        eval_preprocess)

    t_start = time.time()
    cfg = ExperimentConfig().override({"model.temporal_mode": "attention"})
    pred = CollisionPredictor(cfg, None)
    redraw_weights(torch, pred.model, torch.Generator().manual_seed(ATTN_SEED))
    model = pred.model
    model.frame_subsample = 1  # the clips are folded already
    T = cfg.data.num_frames // pred._fold_stride()
    frames = frame_clips(torch, dev, 8, T, CONTENT, seed=23)
    other = frame_clips(torch, dev, 8, T, CONTENT, seed=24)

    def prep(u8):
        return eval_preprocess(u8, cfg.augment, cfg.data.frame_size,
                               torch.bfloat16)

    scale = spread_attention(torch, model, prep(frames))

    counters = zero_counters()
    x = prep(frames)
    logits, full = viz.extract_attention_weights(model, x, per_frame=False)
    torch.cuda.synchronize()
    launches = expect_launches("attention view", counters, K1=1, K2=18,
                               K3=18)
    _, per = viz.extract_attention_weights(model, x)
    with torch.no_grad():
        forward_logits = model(x)
    logits_equal = bool(torch.equal(logits, forward_logits))
    row_err = float(np.abs(full.sum(-1) - 1).max())
    per_is_mean = bool(np.array_equal(per, full.mean(axis=(1, 2))))

    with swapped((convnext, "dwconv7x7", dwconv.dwconv7x7_plain),
                 (convnext, "convnext_mlp", convnext_mlp.convnext_mlp_plain),
                 (preprocess, "dequant_normalize_pad",
                  dequant_pad.dequant_normalize_pad_plain)):
        _, plain_full = viz.extract_attention_weights(model, prep(frames),
                                                      per_frame=False)
    plain_per = plain_full.mean(axis=(1, 2))
    full_err = float(np.abs(full - plain_full).max())
    per_err = float(np.abs(per - plain_per).max())
    spreads = (per.max(1) - per.min(1)).tolist()
    # the check's power: the previous call's matrix, on another batch, and
    # the importance averaged over keys instead of queries (1/T everywhere)
    _, stale = viz.extract_attention_weights(model, prep(other),
                                             per_frame=False)
    faults = {
        "previous_call_full": float(np.abs(stale - plain_full).max()),
        "previous_call_per_frame": float(
            np.abs(stale.mean(axis=(1, 2)) - plain_per).max()),
        "mean_over_keys": float(np.abs(full.mean(axis=(1, 3))
                                       - plain_per).max())}
    log(f"[attention view] query/key scaled by {scale:.4f}; launches "
        f"{launches}; logits bit-equal to the forward: {logits_equal}; "
        f"row sums within {row_err:.2e}; per-frame form the mean: "
        f"{per_is_mean}")
    log(f"[attention view] kernels vs plain: full matrix {full_err:.3e} "
        f"(tol {ATTN_FULL_TOL:.0e}), per frame {per_err:.3e} (tol "
        f"{ATTN_TOL:.1e}); importance spread over T per clip "
        f"{[round(v, 4) for v in spreads]} (min {ATTN_SPREAD_MIN:.2f}); "
        f"faults {faults} (each must exceed its tol)")
    out = {"qk_scale": scale, "launches": launches,
           "logits_bit_equal": logits_equal, "row_sum_err": row_err,
           "per_frame_is_mean": per_is_mean, "tol": ATTN_TOL,
           "full_tol": ATTN_FULL_TOL,
           "full_err": full_err, "per_frame_err": per_err,
           "spread_per_clip": spreads, "faults": faults,
           "importance_clip0": per[0].tolist()}
    if not (logits_equal and per_is_mean and row_err <= ATTN_ROW_TOL):
        raise SystemExit(f"attention view: {out}")
    if full_err > ATTN_FULL_TOL or per_err > ATTN_TOL:
        raise SystemExit("attention view disagrees with its plain version")
    if min(spreads) < ATTN_SPREAD_MIN:
        raise SystemExit(f"attention too flat to test with ({spreads})")
    if not (faults["previous_call_full"] > ATTN_FULL_TOL
            and faults["previous_call_per_frame"] > ATTN_TOL
            and faults["mean_over_keys"] > ATTN_TOL):
        raise SystemExit(f"the tolerance does not see a fault: {faults}")

    def view():
        return viz.extract_attention_weights(model, x)

    def forward():
        with torch.no_grad():
            return model(x)

    def forward_synced():
        # the forward waited for, as a caller that reads its logits does:
        # the view's copy to the host drains the queue the same way
        y = forward()
        torch.cuda.synchronize()
        return y

    out["timing"] = in_turns(
        torch, "attention view", {"view": view, "forward": forward,
                                  "forward_synced": forward_synced},
        lambda fn: median_ms(torch, fn, warmup=2, iters=10, queued=False), 8)
    ms = {k: v["ms"] for k, v in out["timing"].items()}
    ratio = ms["view"] / ms["forward"] - 1
    out["view_over_forward"] = ratio
    out["view_over_forward_synced"] = ms["view"] / ms["forward_synced"] - 1
    log(f"[attention view] the view {ratio * 100:+.2f}% of the forward "
        f"(predicted within +{ATTN_TIME_BAND * 100:.0f}%: one "
        f"{full.nbytes} B copy to the host; reported, not enforced), "
        f"{out['view_over_forward_synced'] * 100:+.2f}% of the forward "
        f"followed by a synchronise")

    # the overlay's frames on clip 0: brightness, and a bar filled in
    # proportion to each frame's min-max normalised weight
    clip = frames[0].cpu().numpy()
    over = viz._overlay_frames(clip, per[0])
    w = per[0].astype(np.float32)
    w_norm = (w - w.min()) / max(float(w.max() - w.min()), 1e-8)
    fills = [int(v * clip.shape[2]) for v in w_norm]
    bar_ok = over.shape == clip.shape and over.dtype == np.uint8 and all(
        bool(np.all(over[i, -8:, :f] == (255, 64, 64)))
        and not bool(np.all(over[i, -8:, f:f + 1] == (255, 64, 64)))
        for i, f in enumerate(fills) if f < clip.shape[2])
    bar_ok = bar_ok and max(fills) == clip.shape[2] and min(fills) == 0
    out["overlay"] = {"shape": list(over.shape), "fills": fills,
                      "bar_ok": bar_ok}
    log(f"[attention view] overlay {over.shape}, bar widths {fills}")
    if not bar_ok:
        raise SystemExit(f"overlay frames: {out['overlay']}")

    ffmpeg = bool(shutil.which("pkg-config")) and subprocess.run(
        ["pkg-config", "--exists", "libavformat"]).returncode == 0
    mpl = importlib.util.find_spec("matplotlib") is not None
    if not (ffmpeg and mpl):
        missing = " / ".join(n for n, have in (("no FFmpeg", ffmpeg),
                                               ("no matplotlib", mpl))
                             if not have)
        line = {"attention_artifacts":
                f"not run: {missing} on this machine"}
        print(json.dumps(line), flush=True)
        out["artifacts"] = line["attention_artifacts"]
    with tempfile.TemporaryDirectory() as tmp:
        made = {}
        if ffmpeg:
            made["mp4"] = viz.render_attention_overlay(
                clip, per[0], os.path.join(tmp, "overlay.mp4"))
            made["html"] = viz.export_batch_preview(
                {"frames": frames[:2].cpu().numpy(), "id": ["a", "b"]}, tmp)
        if mpl:
            made["png"] = viz.plot_attention_heatmap(
                full, os.path.join(tmp, "heatmap.png"))
        sizes = {k: os.path.getsize(p) for k, p in made.items()}
        if made:
            out["artifact_bytes"] = sizes
            log(f"[attention view] artifacts {sizes}")
        if not all(sizes.values()):
            raise SystemExit(f"empty artifact: {sizes}")
    del pred, model, x
    torch.cuda.empty_cache()
    out["launcher"] = launcher_phase(ffmpeg)
    out["phase_s"] = time.time() - t_start
    return out


def launcher_phase(ffmpeg):
    """scripts/run_training_torch.sh in child processes: ``distributed 4``
    through LAUNCHER_STUB on this machine's cards, which must launch one
    process per card (``--nproc-per-node 1`` on one card) and echo the
    batch they share; ``check`` where FFmpeg is installed (the media
    library is built there), else "not run"."""
    import tempfile

    script = os.path.join(ROOT, "scripts", "run_training_torch.sh")
    env = {k: v for k, v in os.environ.items()
           if k not in ("BATCH_SIZE", "DEVICE", "METADATA_CSV", "VIDEO_DIRS")}
    with tempfile.TemporaryDirectory() as tmp:
        stub = os.path.join(tmp, "python")
        with open(stub, "w") as f:
            f.write(LAUNCHER_STUB)
        os.chmod(stub, 0o755)
        rec = os.path.join(tmp, "calls.log")
        run = subprocess.run(
            ["bash", script, "distributed", "4"], cwd=tmp, timeout=120,
            env=dict(env, PYTHON=stub, VCD_REAL_PYTHON=sys.executable,
                     VCD_STUB_LOG=rec), capture_output=True, text=True)
        calls = open(rec).read().splitlines() if os.path.exists(rec) else []
    import torch

    cards = torch.cuda.device_count()
    want_echo = f"effective global batch: {LAUNCHER_BATCH * cards}"
    ok = (run.returncode == 0 and len(calls) == 1
          and f"--nproc-per-node {cards} " in calls[0]
          and calls[0].startswith("-m torch.distributed.run --standalone")
          and want_echo in run.stdout.splitlines())
    out = {"distributed_4": {"rc": run.returncode, "stdout": run.stdout,
                             "calls": calls}}
    log(f"[launcher] distributed 4 on {cards} card(s): rc {run.returncode}, "
        f"{run.stdout.strip()!r}; recorded {calls}")
    if not ok:
        raise SystemExit(f"launcher: {out} {run.stderr[-2000:]}")
    if not ffmpeg:
        line = {"launcher_check": "not run: no FFmpeg on this machine"}
        print(json.dumps(line), flush=True)
        out["check"] = line["launcher_check"]
        return out
    check = subprocess.run(
        ["bash", script, "check"], cwd=ROOT, timeout=300,
        env=dict(env, PYTHON=sys.executable, PYTHONPATH=ROOT),
        capture_output=True, text=True)
    out["check"] = {"rc": check.returncode, "stdout": check.stdout}
    log(f"[launcher] check: rc {check.returncode}, {check.stdout.strip()!r}")
    if check.returncode != 0 or "check passed" not in check.stdout:
        raise SystemExit(f"launcher check: {check.stdout} {check.stderr}")
    return out


# ---- 24. ConvNeXt base and large at full width ---------------------------

BIG_BACKBONES = ("convnext_base", "convnext_large")
BIG_TIME_ITERS = 3             # steps timed, after one warm-up


def big_stage_kernels(torch, dev, name, model, g, record, faults, failed):
    """At each stage of ``model``'s ConvNeXt at its full stage shape
    [200, H, H, C] (224² frames: H 56, 28, 14, 7), on inputs drawn from
    ``g`` on the card: K2's forward (bit-equal twice; taps transposed must
    land outside), dx and wgrad (flipped and swapped taps outside), K3's
    eval and train variants on the kernel ``convnext_mlp.route`` takes
    (both GELU forms; train's out bit-equal to eval's; K3's faults
    outside). Then each timed per launch beside its bound, K3 on the
    split kernel (C = 1024, 1536) beside its plain version, the stock
    chain and ``convnext_mlp.cu`` on the same inputs (the route forced,
    ``mma_sync_ms``) too. → timing rows (``per_forward``: the stage's
    blocks)."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    rows = []
    bb = model.backbone
    for stage, (C, depth) in enumerate(zip(bb.dims, bb.depths)):
        side = (S // 4) >> stage
        shape = (N_FRAMES, side, side, C)
        M, n = N_FRAMES * side * side, N_FRAMES * side * side * C
        x, w, b = k2_inputs(torch, dev, g, shape)
        gy = torch.randn(shape, generator=g, device=g.device).to(
            dev, torch.bfloat16)
        check_k2(torch, x, w, b, record, faults, failed)
        check_k2_dx(torch, x, w, b, gy, record, failed)
        check_k2_wgrad(torch, x, gy, record, failed, faults)
        check_k3_small(torch, dev, g, C, M, record, faults, failed)

        def row(kernel, ms, bound, plain_ms=None):
            rows.append({"kernel": kernel, "model": name,
                         "shape": list(shape), "per_forward": depth,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         "bound_ms": bound[0], "bound_by": bound[1]})

        row(k2_entry(torch, x), median_ms(torch, lambda: k2.dwconv7x7(x, w, b)),
            bound_ms(2 * n * 2 + 50 * C * 2, 98 * n, F32_FLOPS))
        row(k2_wgrad_entry(torch, x),
            median_ms(torch, lambda: k2.dwconv7x7_wgrad(x, gy)),
            bound_ms(2 * n * 2 + 49 * C * 4, 98 * n, F32_FLOPS))
        del x, w, b, gy
        xs = torch.randn(M, C, generator=g, device=g.device).to(
            dev, torch.bfloat16)
        y = torch.randn(M, C, generator=g, device=g.device).to(
            dev, torch.bfloat16)
        p = k3_params(torch, C, g, dev)
        # W1 and W2 as a block hands them over: transposed views of
        # nn.Linear's float32 storage
        p.update(w1=p["w1"].t().contiguous().t(),
                 w2=p["w2"].t().contiguous().t())
        wide = k3.route(torch.bfloat16, C) == "wide"
        eval_entry, train_entry = k3_entries(torch, C, torch.bfloat16)
        if wide:
            stock_ms = median_ms(torch, k3_stock_chain(torch, xs, y, p))
            with swapped((k3, "route", lambda dtype, C_: "mma")):
                mma_ms = [median_ms(torch, lambda: fn(
                    xs, y, approximate=True, **p))
                    for fn in (k3.convnext_mlp, k3.convnext_mlp_train)]
        for i, (entry, fn, plain, bound) in enumerate((
                (eval_entry, k3.convnext_mlp, k3.convnext_mlp_plain,
                 bound_ms(3 * n * 2 + 8 * C * C * 2, 16 * M * C * C,
                          BF16_FLOPS)),
                # x, y, out, t, m at 2 bytes per row-channel, h_pre at 8
                (train_entry, k3.convnext_mlp_train,
                 k3.convnext_mlp_train_plain,
                 bound_ms(18 * n + 8 * C * C * 2, 16 * M * C * C,
                          BF16_FLOPS)))):
            row(entry, median_ms(torch, lambda: fn(xs, y, approximate=True,
                                                   **p)), bound,
                median_ms(torch, lambda: plain(xs, y, approximate=True, **p),
                          warmup=1, iters=3) if wide else None)
            if wide:
                rows[-1].update(mma_sync_ms=mma_ms[i], stock_chain_ms=stock_ms)
        del xs, y, p
    for r in rows:
        more = "".join(f"; {k[:-3]} {r[k]:.4f}" for k in (
            "plain_ms", "mma_sync_ms", "stock_chain_ms")
            if r.get(k) is not None)
        log(f"[{name} time] {r['kernel']} {r['shape']} x{r['per_forward']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}{more})")
    return rows


def big_convnext_phase(torch, dev):
    """Phase 24: ConvNeXt base and large, ``ExperimentConfig()`` with only
    ``model.backbone`` changed (bi-GRU head, 25 frames of 224² after
    thinning, bf16). For each: ``create_train_state`` and one
    ``make_train_step`` on uint8 [8, 50, 126, 224, 3] (``training_step``:
    K2 72, K2 wgrad 36, K3 train 36, 33 of them on the wgmma kernel and
    the last stage's 3 on the split kernel; against the plain step, a
    1% dγ and a dropped K2 db outside), the step timed with its peak
    memory; the same model, its weights redrawn, served by
    ``CollisionPredictor._make_forward(folded_stride=True)`` on uint8
    [8, 25, 126, 224, 3] (``serving_forward``: K1 1, K2 36, K3 36, 33 on
    the wgmma kernel, 3 on the split one; against plain versions, a
    dropped K2 or K3 bias
    outside), timed with its peak memory; then each stage's K2 and K3
    calls against their plain versions and timed
    (``big_stage_kernels``)."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    t_start = time.time()
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    out = {"models": {}, "launches": {}, "timing": []}
    g = torch.Generator(device=dev).manual_seed(24)
    for name in BIG_BACKBONES:
        t0 = time.time()
        cfg = ExperimentConfig().override({"model.backbone": name})
        tr = training_step(torch, dev, cfg=cfg, tag=f"{name} train",
                           fall=False)
        frames, targets, mask = tr["batch"]
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = median_step_ms(
            torch, lambda: tr["step"](tr["state"], frames, targets, mask, gen),
            warmup=1, iters=BIG_TIME_ITERS)
        step_peak = torch.cuda.max_memory_allocated()
        model, train = tr["model"], tr["summary"]
        del tr, frames, targets, mask
        model.zero_grad(set_to_none=True)  # the AdamW moments went with tr
        torch.cuda.empty_cache()

        serve = serving_forward(torch, dev, tag=f"{name} serve", cfg=cfg,
                                model=model, logit_spread=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = median_ms(torch, lambda: serve["forward"](serve["frames"]),
                           warmup=2, iters=10, queued=False)
        fwd_peak = torch.cuda.max_memory_allocated()
        served = serve["summary"]
        del serve
        out["timing"] += big_stage_kernels(torch, dev, name, model, g, record,
                                           faults, failed)
        out["launches"][f"{name}_serve"] = served["launches"]
        out["launches"][f"{name}_train"] = train["launches"]
        del model
        torch.cuda.empty_cache()
        ms = {"forward_ms": fwd_ms, "forward_peak_bytes": fwd_peak,
              "step_ms": step_ms, "step_peak_bytes": step_peak,
              "phase_s": time.time() - t0}
        out["models"][name] = dict(ms, serve=served, train=train)
        log(f"[{name}] forward {fwd_ms:.3f} ms a batch of 8 (peak "
            f"{fwd_peak / 2**30:.2f} GiB), step {step_ms:.3f} ms (peak "
            f"{step_peak / 2**30:.2f} GiB), {ms['phase_s']:.1f} s")
    out.update(compare_rows=rows, faults=faults,
               phase_s=time.time() - t_start)
    if failed:
        raise SystemExit(f"base/large kernels disagree: {failed}")
    return out


# ---- 25. a float32 ConvNeXt trains --------------------------------------------

BIG_F32_TIME_ITERS = 2         # float32 base/large steps timed, after one warm-up


def f32_training_phase(torch, dev):
    """Phase 25: the float32 training paths. The kernel checks and times of
    ``f32_train_kernels``; the flagship with only ``model.dtype="float32"``
    at default switches through ``create_train_state`` and
    ``make_train_step`` (``training_step``: K2 36 and K2 wgrad 18 on their
    Hopper float32 routes, no K3: the float32 default is the stock MLP;
    against the plain step, a dropped K2 db and K2's dw off by 1% outside),
    timed in turns with the bf16 flagship's step, with peak memory; then
    ConvNeXt base and large in float32 built with ``fused_mlp=True`` (the
    JAX package's opt-in): one step (K2 72, K2 wgrad 36, K3 train 36, of
    them 3 on the split kernel's float32 route, the rest on wgmma's; 1% dγ,
    a dropped K2 db and 1% dw outside) and, weights redrawn, the serving
    forward (K1 1, K2 36, K3 36, 3 split; dropped biases outside), each
    timed with peak memory."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    t_start = time.time()
    out = {"launches": {}, "models": {}}
    t0 = time.time()
    out["compare_rows"], out["faults"], out["timing"] = f32_train_kernels(
        torch, dev)
    out["kernels_s"] = time.time() - t0
    log(f"[phase 25 kernels] {out['kernels_s']:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.time()
    f32_cfg = ExperimentConfig().override({"model.dtype": "float32"})
    tr = training_step(torch, dev, cfg=f32_cfg, tag="f32 train", fall=False)
    out["launches"]["f32_train"] = tr["summary"]["launches"]
    # the bf16 flagship's step (phase 6's) on the same batch, for the turns
    bf16_cfg = ExperimentConfig()
    bf16_model, bf16_state = create_train_state(
        bf16_cfg, torch.Generator().manual_seed(3),
        steps_per_epoch=STEPS_PER_EPOCH)
    frames, targets, mask = tr["batch"]
    gen = torch.Generator(device=dev).manual_seed(7)

    def one(step, state):
        return lambda: step(state, frames, targets, mask, gen)

    times = in_turns(
        torch, "f32 train time",
        {"float32": one(tr["step"], tr["state"]),
         "bfloat16": one(make_train_step(bf16_model, bf16_cfg), bf16_state)},
        lambda fn: median_step_ms(torch, fn, warmup=1,
                                  iters=TRAIN_TIME_ITERS), 8)
    out["flagship"] = {"train": tr["summary"], "step": times,
                       "phase_s": time.time() - t0}
    log(f"[phase 25 flagship] {out['flagship']['phase_s']:.1f} s")
    del tr, bf16_model, bf16_state, frames, targets, mask
    torch.cuda.empty_cache()

    for name in BIG_BACKBONES:
        t0 = time.time()
        cfg = ExperimentConfig().override({"model.backbone": name,
                                           "model.dtype": "float32"})
        tr = training_step(torch, dev, cfg=cfg, tag=f"{name} f32 train",
                           fall=False, fused_mlp=True)
        frames, targets, mask = tr["batch"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = median_step_ms(
            torch, lambda: tr["step"](tr["state"], frames, targets, mask, gen),
            warmup=1, iters=BIG_F32_TIME_ITERS)
        step_peak = torch.cuda.max_memory_allocated()
        model, train = tr["model"], tr["summary"]
        del tr, frames, targets, mask
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        serve = serving_forward(torch, dev, tag=f"{name} f32 serve", cfg=cfg,
                                model=model, logit_spread=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = median_ms(torch, lambda: serve["forward"](serve["frames"]),
                           warmup=2, iters=10, queued=False)
        fwd_peak = torch.cuda.max_memory_allocated()
        served = serve["summary"]
        del serve, model
        torch.cuda.empty_cache()
        out["launches"][f"{name}_f32_train"] = train["launches"]
        out["launches"][f"{name}_f32_serve"] = served["launches"]
        ms = {"forward_ms": fwd_ms, "forward_peak_bytes": fwd_peak,
              "step_ms": step_ms, "step_peak_bytes": step_peak,
              "phase_s": time.time() - t0}
        out["models"][name] = dict(ms, serve=served, train=train)
        log(f"[{name} f32] forward {fwd_ms:.3f} ms a batch of 8 (peak "
            f"{fwd_peak / 2**30:.2f} GiB), step {step_ms:.3f} ms (peak "
            f"{step_peak / 2**30:.2f} GiB), {ms['phase_s']:.1f} s")
    out["phase_s"] = time.time() - t_start
    return out


# ---- 26. the float32 scaled ViViT ------------------------------------------

# Phase 26's rules, stated before its first run on the card. Serving: the
# float32 forward's probabilities (the head scaled as in phase 9) against
# the same forward on plain versions, absolute. Everything but K4 is the
# same float32 call on both sides (K1 bit-equal to its plain version), and
# K4's split products put o within about 2^-16 of the largest value of the
# plain float32 attention (phase 8 at [256, 576, 6, 64]: 1.3e-5 of it), so
# each block's output moves by about 1e-5 of its size and the scaled
# logits by about 1e-4; 1e-4 on a probability, where a dropped scale in
# one block moves them by more than 0.3 (phase 9).
VIVIT_F32_SERVE_TOL = 1e-4
# Training: the loss relative and each gradient relative to its norm
# (``rel_grad_errs`` with GRAD_FLOOR) against the plain float32 step: K4's
# forward and backward within about 2^-16 of their plain versions' largest
# value (phase 8) in each of 8 blocks, where bf16's 2^-9 roundings read up
# to 6.3e-2 (phase 11): 2^7 less, about 5e-4 at worst, so 1e-3, where dv
# off by 1% and di left out of dQ's ds must land outside.
VIVIT_F32_TRAIN_TOL = 1e-3
VIVIT_F32_FALL_STEPS = 10      # float32: no bf16 ulp of a weight to step over


def float32_vivit_phase(torch, dev):
    """Phase 26: the scaled ViViT in float32 (phase 9/11's configuration,
    ``model.dtype="float32"``). Serving through ``_make_forward(False)`` on
    phase 9's seeded uint8 batch: launches K1 1 and K4 fwd 8, all on the
    float32 route, and K4 split 8; probabilities that spread; agreement with the forward
    on plain versions (VIVIT_F32_SERVE_TOL), a scale dropped in block 1 or
    8 outside; ms per batch in turns with float32 ``"xla"`` and bf16
    ``"flash"``, peak memory. Training, one ``make_train_step`` on phase
    11's batch (``remat=False``): K4 fwd, dK/dV, dQ and di 8 each, on the
    float32 routes, and K4 split 16; every gradient finite, every spatial block's
    projections nonzero; loss and gradients against the plain float32
    step with ``remat=True`` (VIVIT_F32_TRAIN_TOL), di left out of dQ's ds
    and dv off by 1% outside; the loss falling on a fixed batch; ms per
    step in turns with float32 ``"xla"`` and bf16 ``"flash"``, peak
    memory."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.ops import (
        dequant_pad, flash_attention as fa, preprocess)
    from vision_collision_detection_tpu_torch.train import (
        TrainState, build_optimizer, create_train_state, make_train_step)

    t_start = time.time()
    out = {"launches": {}}
    failed = []
    f32 = {"model.dtype": "float32"}
    cfg = vivit_cfg(**f32)

    # -- serving
    pred, frames = vivit_predictor(torch, dev, cfg)
    forward = pred._make_forward(folded_stride=False)
    torch.cuda.synchronize()
    counters = zero_counters()
    probs = forward(frames)
    torch.cuda.synchronize()
    launches = expect_launches("vivit f32 serve", counters, K1=1,
                               K4_fwd=VIVIT_BLOCKS, K4_split=VIVIT_BLOCKS)
    if launches["K4 fwd (f32)"] != VIVIT_BLOCKS:
        failed.append(f"the serving forward's K4 took {launches}")
    out["launches"]["vivit_f32_serve"] = launches
    log(f"[vivit f32 serve] probs {probs.tolist()}")
    if tuple(probs.shape) != (VIVIT_BATCH, 3) or not bool(
            torch.isfinite(probs).all()):
        raise SystemExit(f"bad probabilities {probs}")
    spread = float((probs.max(0).values - probs.min(0).values).max())
    if spread < SPREAD_MIN:
        failed.append(f"probabilities too alike to test with ({spread})")

    def plain_forward(fwd=None):
        with swapped(*flash_plain_swaps(fwd=fwd),
                     (preprocess, "dequant_normalize_pad",
                      dequant_pad.dequant_normalize_pad_plain)):
            got = forward(frames)
            torch.cuda.synchronize()
        return got

    def scale_dropped_in(block):
        calls = [0]

        def fwd(q, k, v, sm_scale, need_lse=True):
            calls[0] += 1
            return fa._flash_fwd_plain(
                q, k, v, 1.0 if calls[0] == block else sm_scale, need_lse)
        return fwd

    err = max_err(torch, probs, plain_forward())
    power = {f"sm_scale_dropped_in_block_{b}": max_err(
        torch, probs, plain_forward(scale_dropped_in(b)))
        for b in (1, VIVIT_BLOCKS)}
    log(f"[vivit f32 serve] spread {spread:.4f}; kernels vs plain: max "
        f"|Δprob| {err:.3e} (tol {VIVIT_F32_SERVE_TOL:.0e}); faults {power}")
    if not err <= VIVIT_F32_SERVE_TOL:
        failed.append(f"the float32 forward disagrees with its plain "
                      f"version ({err})")
    if not all(v > VIVIT_F32_SERVE_TOL for v in power.values()):
        failed.append(f"the tolerance does not see a dropped scale: {power}")
    sd = pred.model.state_dict()
    variants = {
        "float32 flash": forward,
        "float32 xla": CollisionPredictor(
            cfg.override({"model.attention_impl": "xla"}),
            sd)._make_forward(False),
        "bfloat16 flash": CollisionPredictor(vivit_cfg(),
                                             sd)._make_forward(False)}
    out["forward"] = in_turns(torch, "vivit f32 forward", {
        name: (lambda fwd=fwd: fwd(frames)) for name, fwd in variants.items()},
        lambda fn: median_ms(torch, fn, warmup=2, iters=10, queued=False),
        VIVIT_BATCH)
    out["serve"] = {"probs": probs.tolist(), "spread": spread,
                    "max_abs_err_vs_plain": err, "tol": VIVIT_F32_SERVE_TOL,
                    "faults_max_abs_err": power}
    del pred, frames, forward, variants, sd, probs
    torch.cuda.empty_cache()

    # -- training
    def fresh(cfg_):
        model, state = create_train_state(
            cfg_, torch.Generator().manual_seed(13),
            steps_per_epoch=STEPS_PER_EPOCH)
        return model, state, make_train_step(model, cfg_)

    def grads_of(model):
        return {n: p.grad.detach().float().clone()
                for n, p in model.named_parameters()}

    batch = vivit_noise_batch(torch, dev, cfg.data.num_frames, VIVIT_BATCH,
                              14)
    model, state, step = fresh(cfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_init = copy.deepcopy(state.optimizer.state_dict())

    def run(model_, state_, step_):
        """One step from the initial weights and optimizer state."""
        model_.load_state_dict(init)
        state_.optimizer.load_state_dict(opt_init)
        state_.step = 0
        _, m = step_(state_, *batch,
                     torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        torch.cuda.synchronize()
        return {k: float(v) for k, v in m.items()}, grads_of(model_)

    counters = zero_counters()
    torch.cuda.reset_peak_memory_stats()
    metrics, grads = run(model, state, step)
    launches = expect_launches(
        "vivit f32 train", counters, K4_fwd=VIVIT_BLOCKS,
        K4_bwd_dKdV=VIVIT_BLOCKS, K4_bwd_dQ=VIVIT_BLOCKS,
        K4_bwd_di=VIVIT_BLOCKS, K4_split=2 * VIVIT_BLOCKS,
        train_preprocess=2)
    if any(launches[f"{k} (f32)"] != VIVIT_BLOCKS
           for k in ("K4 fwd", "K4 bwd dKdV", "K4 bwd dQ")):
        failed.append(f"the step's K4 took {launches}")
    out["launches"]["vivit_f32_train"] = launches
    if not math.isfinite(metrics["loss"]):
        raise SystemExit(f"non-finite loss {metrics}")
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    attn = [n for n in grads if n.startswith("spatial_") and ".attn." in n
            and not n.endswith(".key.bias")]
    zero = [n for n in attn if float(grads[n].abs().max()) == 0.0]
    log(f"[vivit f32 train] metrics {metrics}; {len(grads)} parameters; "
        f"non-finite {bad}; {len(attn)} spatial attention parameters, zero "
        f"{zero}")
    if bad or zero or len(attn) != 7 * VIVIT_BLOCKS:
        failed.append("a parameter's gradient is missing, non-finite or zero")

    # the plain float32 step, remat on (phase 11: remat changes no number)
    m_plain, s_plain, step_plain = fresh(cfg.override({"model.remat": True}))
    with swapped(*flash_plain_swaps()):
        plain_metrics, plain_grads = run(m_plain, s_plain, step_plain)
    loss_err = abs(metrics["loss"] - plain_metrics["loss"]) / abs(
        plain_metrics["loss"])
    errs = rel_grad_errs(torch, grads, plain_grads, GRAD_FLOOR)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"[vivit f32 train] kernels vs plain: loss {metrics['loss']:.7f} vs "
        f"{plain_metrics['loss']:.7f} (rel {loss_err:.2e}); worst gradient "
        f"errors {[(n, f'{e:.2e}') for n, e in worst]} (tol "
        f"{VIVIT_F32_TRAIN_TOL:.0e})")
    if loss_err > VIVIT_F32_TRAIN_TOL or worst[0][1] > VIVIT_F32_TRAIN_TOL:
        failed.append("the float32 step disagrees with its plain version")

    def dq_no_di(q, k, v, do, lse, di, sm_scale, split=None):
        return fa.flash_mha_bwd_dq_plain(q, k, v, do, lse,
                                         torch.zeros_like(di), sm_scale)

    def dkv_dv_off(*args, split=None):
        dk, dv = fa.flash_mha_bwd_dkv_plain(*args)
        return dk, dv * 1.01

    with swapped(*flash_plain_swaps(dq=dq_no_di, dkv=dkv_dv_off)):
        _, fault_grads = run(m_plain, s_plain, step_plain)
    ferrs = rel_grad_errs(torch, fault_grads, grads, GRAD_FLOOR)
    power = {
        "dq_without_di": min(e for n, e in ferrs.items() if n.startswith(
            "spatial_") and n.endswith(".attn.query.weight")),
        "dv_1pct": min(e for n, e in ferrs.items() if n.startswith(
            "spatial_") and n.endswith(".attn.value.weight"))}
    log(f"[vivit f32 train] faults, least relative gradient error over the "
        f"affected parameters: {power} (must exceed tol "
        f"{VIVIT_F32_TRAIN_TOL:.0e})")
    if not all(v > VIVIT_F32_TRAIN_TOL for v in power.values()):
        failed.append(f"the tolerance does not see a backward fault: {power}")
    del m_plain, s_plain, step_plain, plain_grads, fault_grads
    torch.cuda.empty_cache()

    fixed_cfg = cfg.override({"augment.enabled": False,
                              "augment.horizontal_flip_prob": 0.0,
                              "optim.learning_rate": VIVIT_FALL_RATE})
    model.load_state_dict(init)
    fixed_state = TrainState(
        *build_optimizer(fixed_cfg.optim, model.parameters(),
                         STEPS_PER_EPOCH),
        float(fixed_cfg.optim.grad_clip_norm))
    fixed_step = make_train_step(model, fixed_cfg)
    losses = []
    for _ in range(VIVIT_F32_FALL_STEPS):
        _, m = fixed_step(fixed_state, *batch,
                          torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        losses.append(float(m["loss"]))
    log(f"[vivit f32 train] fixed batch, augmentation off: losses {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"the loss did not fall: {losses}")
    del fixed_state, fixed_step

    xla_model, xla_state, xla_step = fresh(
        cfg.override({"model.attention_impl": "xla"}))
    bf_model, bf_state, bf_step = fresh(vivit_cfg())
    gen = torch.Generator(device=dev).manual_seed(7)
    out["step"] = in_turns(torch, "vivit f32 train time", {
        name: (lambda st=st, fn=fn: fn(st, *batch, gen))
        for name, (st, fn) in {"float32 flash": (state, step),
                               "float32 xla": (xla_state, xla_step),
                               "bfloat16 flash": (bf_state, bf_step)}.items()},
        lambda fn: median_step_ms(torch, fn, warmup=2,
                                  iters=TRAIN_TIME_ITERS), VIVIT_BATCH)
    out["train"] = {"metrics": metrics, "plain_metrics": plain_metrics,
                    "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
                    "tol": VIVIT_F32_TRAIN_TOL, "faults_least_rel_err": power,
                    "fixed_batch_losses": losses}
    del model, state, step, xla_model, xla_state, xla_step, bf_model
    del bf_state, bf_step
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_start
    if failed:
        raise SystemExit(f"the float32 ViViT: {failed}")
    return out


# ---- 27. vivit_tiny with "flash" (K4 at head_dim 16) -----------------------

# vivit_tiny, the JAX package's own preset (dim 64, 2 spatial blocks and 1
# temporal block, 4 heads of 16), at phase 9's configuration with 224²
# frames: patch 14 gives 256 tokens a frame, so K4 runs on [256, 256, 4,
# 16] (FLASH_D16), 2 launches a pass.
VIVIT_TINY_OVERRIDES = {"model.backbone": "vivit_tiny",
                        "data.frame_size": 224}
VIVIT_TINY_CONTENT = (126, 224)  # 16:9 source letterboxed into 224²
VIVIT_TINY_TABLE = (256, 64)     # spatial position table: tokens, dim
# Tolerances, stated before the first run on the card, by the rules of the
# phases whose shape this is at another width:
# - serving (head ×10, probabilities): bf16 phase 9's 2e-2 (bf16 flips in
#   each block's activations), float32 phase 26's 1e-4 (VIVIT_F32_SERVE_TOL);
#   the scale dropped in block 1 or 2 must land outside;
# - training, the loss relative and each gradient relative to its norm:
#   bf16 phase 11's VIVIT_TRAIN_TOL (4e-2; the temporal block's query and
#   key VIVIT_TEMPORAL_QK_TOL, 1e-1), with di left out of dQ's ds and dv
#   × 1.10 outside (a bf16 step's own spread against its plain version
#   reaches 2e-2, phase 11, so a 1% fault in dv cannot be told from it);
#   float32 phase 26's VIVIT_F32_TRAIN_TOL (1e-3), with di left out and dv
#   × 1.01 outside.
VIVIT_TINY_DV_FAULT = {"bfloat16": 1.10, "float32": 1.01}


def vivit_tiny_phase(torch, dev):
    """Phase 27: vivit_tiny with ``attention_impl="flash"`` served and
    trained on the card in bf16 and in float32, K4 on its head_dim-16
    Hopper kernels. Per dtype: phase 9's predictor and batch (content
    [8, 32, 126, 224, 3]) through ``_make_forward(False)``: launches K1 1
    and K4 fwd 2 on the dtype's head_dim-16 route (float32 also K4 split
    2); probabilities that spread; agreement with the forward on plain
    versions, the scale dropped in block 1 or 2 outside; ms and peak memory
    in turns with ``"xla"``. Then one ``make_train_step`` on phase 11's
    batch (blur off): K4 fwd, dK/dV, dQ and di 2 each (float32 also K4
    split 4), every gradient finite and every spatial block's projections
    nonzero; the step against the plain step, di left out of dQ's ds and
    dv off (VIVIT_TINY_DV_FAULT) outside; ms and peak memory in turns with
    ``"xla"``."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.ops import (
        dequant_pad, flash_attention as fa, preprocess)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    t_start = time.time()
    out = {"launches": {}}
    failed = []
    blocks = VIVIT_TINY_BLOCKS
    for dtype in ("bfloat16", "float32"):
        f32 = dtype == "float32"
        cfg = vivit_cfg(**VIVIT_TINY_OVERRIDES, **{"model.dtype": dtype})
        tag = f"vivit_tiny {dtype}"
        key = "vivit_tiny" + ("_f32" if f32 else "")
        rec = out[dtype] = {}
        fwd_entry = flash_entry("fwd", dtype, 16)
        split = {"K4_split": blocks} if f32 else {}

        # -- serving
        pred, frames = vivit_predictor(torch, dev, cfg, VIVIT_TINY_CONTENT,
                                       VIVIT_TINY_TABLE)
        forward = pred._make_forward(folded_stride=False)
        torch.cuda.synchronize()
        counters = zero_counters()
        probs = forward(frames)
        torch.cuda.synchronize()
        launches = expect_launches(f"{tag} serve", counters, K1=1,
                                   K4_fwd=blocks, **split)
        if launches[fwd_entry] != blocks:
            failed.append(f"{tag}: the serving forward's K4 took {launches}")
        out["launches"][f"{key}_serve"] = launches
        log(f"[{tag} serve] probs {probs.tolist()}")
        if tuple(probs.shape) != (VIVIT_BATCH, 3) or not bool(
                torch.isfinite(probs).all()):
            raise SystemExit(f"{tag}: bad probabilities {probs}")
        row_err = float((probs.sum(-1) - 1).abs().max())
        spread = float((probs.max(0).values - probs.min(0).values).max())
        if row_err > 1e-5 or spread < SPREAD_MIN:
            failed.append(f"{tag}: probability rows off by {row_err} or "
                          f"too alike to test with ({spread})")

        def plain_forward(fwd=None):
            with swapped(*flash_plain_swaps(fwd=fwd),
                         (preprocess, "dequant_normalize_pad",
                          dequant_pad.dequant_normalize_pad_plain)):
                got = forward(frames)
                torch.cuda.synchronize()
            return got

        def scale_dropped_in(block):
            calls = [0]

            def fwd(q, k, v, sm_scale, need_lse=True, split=None):
                calls[0] += 1
                return fa._flash_fwd_plain(
                    q, k, v, 1.0 if calls[0] == block else sm_scale, need_lse)
            return fwd

        tol = VIVIT_F32_SERVE_TOL if f32 else SERVE_TOL
        err = max_err(torch, probs, plain_forward())
        power = {f"sm_scale_dropped_in_block_{b}": max_err(
            torch, probs, plain_forward(scale_dropped_in(b)))
            for b in (1, blocks)}
        log(f"[{tag} serve] spread {spread:.4f}; kernels vs plain: max "
            f"|Δprob| {err:.3e} (tol {tol:.0e}); faults {power}")
        if not err <= tol:
            failed.append(f"{tag}: the forward disagrees with its plain "
                          f"version ({err})")
        if not all(v > tol for v in power.values()):
            failed.append(f"{tag}: the tolerance does not see a dropped "
                          f"scale: {power}")
        xla = CollisionPredictor(cfg.override({"model.attention_impl": "xla"}),
                                 pred.model.state_dict())._make_forward(False)
        rec["forward"] = in_turns(torch, f"{tag} forward", {
            name: (lambda fwd=fwd: fwd(frames))
            for name, fwd in {"flash": forward, "xla": xla}.items()},
            lambda fn: median_ms(torch, fn, warmup=2, iters=10,
                                 queued=False), VIVIT_BATCH)
        rec["serve"] = {"probs": probs.tolist(), "spread": spread,
                        "row_sum_err": row_err, "max_abs_err_vs_plain": err,
                        "tol": tol, "faults_max_abs_err": power}
        del pred, frames, forward, xla, probs
        torch.cuda.empty_cache()

        # -- training
        def fresh(cfg_):
            model, state = create_train_state(
                cfg_, torch.Generator().manual_seed(13),
                steps_per_epoch=STEPS_PER_EPOCH)
            return model, state, make_train_step(model, cfg_)

        def grads_of(model):
            return {n: p.grad.detach().float().clone()
                    for n, p in model.named_parameters()}

        batch = vivit_noise_batch(torch, dev, cfg.data.num_frames,
                                  VIVIT_BATCH, 14, VIVIT_TINY_CONTENT)
        model, state, step = fresh(cfg)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        opt_init = copy.deepcopy(state.optimizer.state_dict())

        def run():
            """One step from the initial weights and optimizer state."""
            model.load_state_dict(init)
            state.optimizer.load_state_dict(opt_init)
            state.step = 0
            _, m = step(state, *batch,
                        torch.Generator(device=dev).manual_seed(TRAIN_SEED))
            torch.cuda.synchronize()
            return {k: float(v) for k, v in m.items()}, grads_of(model)

        counters = zero_counters()
        metrics, grads = run()
        launches = expect_launches(
            f"{tag} train", counters, K4_fwd=blocks,
            K4_bwd_dKdV=blocks, K4_bwd_dQ=blocks, K4_bwd_di=blocks,
            train_preprocess=2, **({"K4_split": 2 * blocks} if f32 else {}))
        if any(launches[flash_entry(kind, dtype, 16)] != blocks
               for kind in ("fwd", "bwd dKdV", "bwd dQ")):
            failed.append(f"{tag}: the step's K4 took {launches}")
        out["launches"][f"{key}_train"] = launches
        if not math.isfinite(metrics["loss"]):
            raise SystemExit(f"{tag}: non-finite loss {metrics}")
        bad = [n for n, v in grads.items()
               if not bool(torch.isfinite(v).all())]
        attn = [n for n in grads if n.startswith("spatial_")
                and ".attn." in n and not n.endswith(".key.bias")]
        zero = [n for n in attn if float(grads[n].abs().max()) == 0.0]
        log(f"[{tag} train] metrics {metrics}; {len(grads)} parameters; "
            f"non-finite {bad}; {len(attn)} spatial attention parameters, "
            f"zero {zero}")
        if bad or zero or len(attn) != 7 * blocks:
            failed.append(f"{tag}: a parameter's gradient is missing, "
                          f"non-finite or zero")

        with swapped(*flash_plain_swaps()):
            plain_metrics, plain_grads = run()
        loss_err = abs(metrics["loss"] - plain_metrics["loss"]) / abs(
            plain_metrics["loss"])
        errs = rel_grad_errs(torch, grads, plain_grads, GRAD_FLOOR)
        tol = VIVIT_F32_TRAIN_TOL if f32 else VIVIT_TRAIN_TOL
        loose = ({} if f32 else {
            n: e for n, e in errs.items() if n.startswith("temporal_")
            and (".attn.query." in n or ".attn.key." in n)})
        worst = max(((n, e) for n, e in errs.items() if n not in loose),
                    key=lambda kv: kv[1])
        worst_loose = max(loose.items(), key=lambda kv: kv[1],
                          default=("none", 0.0))
        log(f"[{tag} train] kernels vs plain: loss {metrics['loss']:.7f} vs "
            f"{plain_metrics['loss']:.7f} (rel {loss_err:.2e}); worst "
            f"gradient {worst} (tol {tol:.0e}); temporal query/key "
            f"{worst_loose} (tol {VIVIT_TEMPORAL_QK_TOL:.0e})")
        if (loss_err > tol or worst[1] > tol
                or worst_loose[1] > VIVIT_TEMPORAL_QK_TOL):
            failed.append(f"{tag}: the step disagrees with its plain version")

        def dq_no_di(q, k, v, do, lse, di, sm_scale, split=None):
            return fa.flash_mha_bwd_dq_plain(q, k, v, do, lse,
                                             torch.zeros_like(di), sm_scale)

        def dkv_dv_off(*args, split=None):
            dk, dv = fa.flash_mha_bwd_dkv_plain(*args)
            return dk, (dv.float() * VIVIT_TINY_DV_FAULT[dtype]).to(dv.dtype)

        with swapped(*flash_plain_swaps(dq=dq_no_di, dkv=dkv_dv_off)):
            _, fault_grads = run()
        ferrs = rel_grad_errs(torch, fault_grads, grads, GRAD_FLOOR)
        power = {
            "dq_without_di": min(e for n, e in ferrs.items() if n.startswith(
                "spatial_") and n.endswith(".attn.query.weight")),
            f"dv_x{VIVIT_TINY_DV_FAULT[dtype]}": min(
                e for n, e in ferrs.items() if n.startswith("spatial_")
                and n.endswith(".attn.value.weight"))}
        log(f"[{tag} train] faults, least relative gradient error over the "
            f"affected parameters: {power} (must exceed tol {tol:.0e})")
        if not all(v > tol for v in power.values()):
            failed.append(f"{tag}: the tolerance does not see a backward "
                          f"fault: {power}")
        del plain_grads, fault_grads

        xla_model, xla_state, xla_step = fresh(
            cfg.override({"model.attention_impl": "xla"}))
        gen = torch.Generator(device=dev).manual_seed(7)
        rec["step"] = in_turns(torch, f"{tag} train time", {
            name: (lambda st=st, fn=fn: fn(st, *batch, gen))
            for name, (st, fn) in {"flash": (state, step),
                                   "xla": (xla_state, xla_step)}.items()},
            lambda fn: median_step_ms(torch, fn, warmup=2,
                                      iters=TRAIN_TIME_ITERS), VIVIT_BATCH)
        rec["train"] = {"metrics": metrics, "plain_metrics": plain_metrics,
                        "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
                        "worst_temporal_qk": worst_loose, "tol": tol,
                        "faults_least_rel_err": power}
        del model, state, step, xla_model, xla_state, xla_step, batch, grads
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_start
    if failed:
        raise SystemExit(f"vivit_tiny: {failed}")
    return out


# ---- 28. the fused training preprocess -----------------------------------

# (B, T, ch, cw, S): the kernel against the chain at vivit_small's and the
# flagship's content, small batches, every case; then at the main paths'
# batches (clips of several groups of FPB = 8 frames, the flagship's last
# group partial), the cases of PREPROCESS_MAIN_CASES; then timed there
PREPROCESS_COMPARE = ((4, 3, 189, 336, 336), (4, 3, 126, 224, 224))
PREPROCESS_COMPARE_MAIN = ((8, 32, 189, 336, 336), (8, 50, 126, 224, 224))
PREPROCESS_MAIN_CASES = ("draws", "skip", "cutout")
PREPROCESS_TIMED = ((8, 32, 189, 336, 336, "bfloat16"),
                    (8, 50, 126, 224, 224, "bfloat16"),
                    (8, 32, 189, 336, 336, "float32"))
# each step forced on, one at a time, over vivit_small's augmentation
PREPROCESS_CASES = {
    "draws": {}, "flip": {"horizontal_flip_prob": 1.0},
    "skip": {"aug_probability": 0.0}, "grayscale": {"grayscale_prob": 1.0},
    "cutout": {"cutout_prob": 1.0}, "posterize": {"posterization_prob": 1.0},
    "solarize": {"solarization_prob": 1.0},
    "invert": {"color_inversion_prob": 1.0}, "disabled": {"enabled": False}}
# Kernel against chain, max and mean |Δ| of the normalised frames (the card
# test's, tests/test_torch_fused_preprocess.py, gives the reasons): two
# flips of a bf16-rounded warp operand and an output's last bf16 bit;
# posterize a step more; the mean 1e-5 (4e-8 read on an H100).
PREPROCESS_MAX_TOL = 2 ** -6 + 2 * 2 ** -8 / 0.225
PREPROCESS_POSTERIZE_TOL = PREPROCESS_MAX_TOL + 32 / 255 / 0.225
PREPROCESS_MEAN_TOL = 1e-5

def fused_preprocess_phase(torch, dev):
    """Phase 28: the fused training preprocess (``ops/csrc/
    train_preprocess.cu``) against the chain (``train_preprocess_plain``)
    from the same generator seed: at 189×336 → 336 and 126×224 → 224, each
    of ``PREPROCESS_CASES`` (every step forced on in turn) at
    ``PREPROCESS_COMPARE``'s small batches and ``PREPROCESS_MAIN_CASES`` at
    the main paths' batches, both warps, bf16 and float32 out; the kernel
    given a faulty table (hue + 0.02, the flips inverted, the rows shifted
    by one, the contrast means at 0) must land outside the mean tolerance.
    Then at the cells' batches, in turns with the chain: the two launches
    (ms, the contrast means alone), the whole call with its draws, the
    chain, the bound (bytes: the content read once, the frames written
    once) and the design's own bytes (the content read twice) as
    ``design_bound_ms``."""
    from vision_collision_detection_tpu_torch.config import AugmentConfig
    from vision_collision_detection_tpu_torch.ops import (
        fused_preprocess as fp, preprocess)

    t_start = time.time()
    out = {"compare": [], "faults": [], "timing": []}
    failed = []
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def cfg_of(case="draws", mode="separable"):
        return AugmentConfig(**{"blur_sigma": 0.0, "aug_probability": 1.0,
                                "affine_mode": mode,
                                **PREPROCESS_CASES[case]})

    def frames_of(B, T, ch, cw, seed=7):
        return torch.randint(0, 256, (B, T, ch, cw, 3), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(seed)
                             ).to(dev)

    compared = [(shape, tuple(PREPROCESS_CASES))
                for shape in PREPROCESS_COMPARE] + [
        (shape, PREPROCESS_MAIN_CASES) for shape in PREPROCESS_COMPARE_MAIN]
    for (B, T, ch, cw, S), cases in compared:
        frames = frames_of(B, T, ch, cw)
        for case in cases:
            for mode in fp.WARP_MODES:
                for name, od in dtypes.items():
                    cfg = cfg_of(case, mode)
                    got = preprocess.train_preprocess(
                        torch.Generator(dev).manual_seed(5), frames, cfg, S,
                        od)
                    want = preprocess.train_preprocess_plain(
                        torch.Generator(dev).manual_seed(5), frames, cfg, S,
                        od)
                    err = (got.float() - want.float()).abs()
                    row = {"entry": "train preprocess",
                           "shape": [B, T, ch, cw, S], "case": case,
                           "mode": mode, "dtype": name,
                           "max_abs_err": float(err.max()),
                           "mean_abs_err": float(err.mean())}
                    out["compare"].append(row)
                    mx = (PREPROCESS_POSTERIZE_TOL if case == "posterize"
                          else PREPROCESS_MAX_TOL)
                    if (row["max_abs_err"] > mx
                            or row["mean_abs_err"] > PREPROCESS_MEAN_TOL):
                        failed.append(f"train preprocess {row}")
        log(f"[phase 28] {B}×{T} at {S}: worst max |Δ| so far "
            f"{max(r['max_abs_err'] for r in out['compare'])}, worst mean "
            f"{max(r['mean_abs_err'] for r in out['compare'])}")
        del frames, got, want, err
        torch.cuda.empty_cache()

    # faults: the kernel on a wrong table, against the chain's frames
    B, T, ch, cw, S = PREPROCESS_COMPARE[0]
    frames, cfg = frames_of(B, T, ch, cw), cfg_of()
    want = preprocess.train_preprocess_plain(
        torch.Generator(dev).manual_seed(5), frames, cfg, S, torch.bfloat16)
    good = fp.draw_table(torch.Generator(dev).manual_seed(5), B, cfg, S)

    def shifted(col, by):
        t = good.clone()
        t[:, col] += by
        return t

    flipped = good.clone()
    flipped[:, fp.FLIP] = 1 - flipped[:, fp.FLIP]
    faults = {"hue + 0.02": (shifted(fp.HUE, 0.02), 1),
              "flips inverted": (flipped, 1),
              "rows shifted by one": (shifted(fp.WARP + 5, 1.0), 1),
              "contrast means at 0": (good, 0)}
    for name, (table, augment) in faults.items():
        means = torch.zeros(B * T, device=dev)
        outp = torch.empty(B, T, S, S, 3, dtype=torch.bfloat16, device=dev)
        fp._launch(frames, table, means, outp, cfg, augment)
        err = (outp.float() - want.float()).abs()
        row = {"fault": name, "max_abs_err": float(err.max()),
               "mean_abs_err": float(err.mean())}
        out["faults"].append(row)
        if row["mean_abs_err"] <= PREPROCESS_MEAN_TOL:
            failed.append(f"train preprocess: the fault {name!r} lands "
                          f"inside the tolerance ({row})")
    log(f"[phase 28] faults {out['faults']}")

    for B, T, ch, cw, S, name in PREPROCESS_TIMED:
        od, cfg = dtypes[name], cfg_of()
        frames = frames_of(B, T, ch, cw, seed=8)
        table = fp.draw_table(torch.Generator(dev).manual_seed(1), B, cfg, S)
        means = torch.empty(B * T, device=dev)
        outp = torch.empty(B, T, S, S, 3, dtype=od, device=dev)
        # the means for the timed frames-only launch
        fp._launch(frames, table, means, outp, cfg, 1)
        gen = torch.Generator(dev).manual_seed(1)
        kernel_ms, plain_ms = in_turns_ms(
            torch, lambda: fp._launch(frames, table, means, outp, cfg, 1),
            lambda: preprocess.train_preprocess_plain(gen, frames, cfg, S,
                                                      od))
        frames_only = median_ms(
            torch, lambda: fp._launch(frames, table, means, outp, cfg, 0))
        whole = median_ms(torch, lambda: preprocess.train_preprocess(
            gen, frames, cfg, S, od))
        # the function reads the content once; this design reads it twice
        # (the contrast means, then the frames)
        written = outp.numel() * outp.element_size()
        b, by = bound_ms(frames.numel() + written, 0, F32_FLOPS)
        design_b, _ = bound_ms(2 * frames.numel() + written, 0, F32_FLOPS)
        row = {"kernel": "train preprocess", "shape": [B, T, ch, cw, S],
               "dtype": name, "per_forward": 1, "ms": kernel_ms,
               "means_ms": kernel_ms - frames_only, "whole_call_ms": whole,
               "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
               "design_bound_ms": design_b, "library_ms": None}
        out["timing"].append(row)
        log(f"[phase 28] {row}")
        del frames, outp
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_start
    if failed:
        raise SystemExit("phase 28 failed:\n" + "\n".join(failed[:20]))
    return out


# ---- 29. TimeSformer-HR ---------------------------------------------------

# the benchmark's configuration: augmentation without blur, so that the
# step takes the fused preprocess
TSF_OVERRIDES = {"model.backbone": "timesformer_hr", "model.patch_size": 16,
                 "model.attention_impl": "flash", "data.frame_size": 448,
                 "data.fps": 4, "data.duration": 4, "augment.blur_sigma": 0.0}
TSF_CONTENT = (252, 448)        # 16:9 source letterboxed into 448²
TSF_BLOCKS = 12
TSF_HEADS = 12
# the step against the plain step at this many clips (the plain K4 keeps
# float32 [B·16, 12, 785, 785] logits)
TSF_PLAIN_BATCH = 2
# K4's two calls a block at B=8 on the bf16 head_dim-64 route: the spatial
# attention over 785 tokens of each of the 128 frames (a ragged last tile
# of queries and keys) and the temporal over 16 frames, the 784 positions
# folded into the heads (one 192-query item and one 128-key block holding
# 16 rows)
TSF_K4_SHAPES = ((128, 785, 12, 64, "bfloat16"),
                 (8, 16, 784 * 12, 64, "bfloat16"))


def time_divided_k4(torch, dev, shapes=TSF_K4_SHAPES):
    """ms a launch of K4's forward (without the log-sum-exp), dK/dV and dQ
    at each of ``shapes``, CUDA events around each, beside the plain
    versions and SDPA forward and backward (one call for dq, dk, dv) on the
    same inputs, and the bound of each: the function's products (2, 4 and
    3 of 2·S²·D operations a (batch, head)) at the bf16 peak or its bytes
    (q, k, v, o; q, k, v, do, dk, dv with lse and di; q, k, v, do, dq with
    lse and di) at the HBM rate. The ``mma.sync`` yardstick of
    ``time_flash_routes`` has no bf16 head_dim-64 backward. → rows."""
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    rows = []
    g = torch.Generator().manual_seed(22)
    for shape in shapes:
        B, S, H, D, _ = shape
        q, k, v, do = flash_inputs(torch, shape, dev, g)
        scale = D ** -0.5
        o, lse = fa.flash_mha_fwd(q, k, v, scale)
        di = fa.flash_mha_bwd_di(o, do)
        args = (q, k, v, do, lse, di, scale)
        n, stats, pairs = q.numel(), B * H * S * 4, B * H
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        with torch.no_grad():
            fwd = median_ms(torch, lambda: fa._launch_fwd(
                q, k, v, scale, need_lse=False))
            lib_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            plain_fwd = median_ms(
                torch, lambda: fa.flash_mha_plain(q, k, v, scale), iters=5)
        dkv = median_ms(torch, lambda: fa.flash_mha_bwd_dkv(*args))
        dq = median_ms(torch, lambda: fa.flash_mha_bwd_dq(*args))
        plain_dkv = median_ms(
            torch, lambda: fa.flash_mha_bwd_dkv_plain(*args), iters=5)
        plain_dq = median_ms(
            torch, lambda: fa.flash_mha_bwd_dq_plain(*args), iters=5)
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dot, retain_graph=True))
        del lib_out, leaves
        for kind, ms, products, n_bytes, plain, lib in (
                ("fwd", fwd, 2, 8 * n, plain_fwd, lib_fwd),
                ("bwd dKdV", dkv, 4, 12 * n + 2 * stats, plain_dkv, lib_bwd),
                ("bwd dQ", dq, 3, 10 * n + 2 * stats, plain_dq, lib_bwd)):
            b, by = bound_ms(n_bytes, 2 * products * S * S * D * pairs,
                             BF16_FLOPS)
            rows.append({"kernel": f"K4 {kind}", "shape": list(shape),
                         "ms": ms, "bound_ms": b, "bound_by": by,
                         "plain_ms": plain, "library_ms": lib})
            log(f"[timesformer K4] {kind} {list(shape)}: {ms:.4f} ms (bound "
                f"{b:.4f} ms by {by}; plain {plain:.4f}; SDPA {lib:.4f})")
        del q, k, v, do, o, lse, di, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


def timesformer_phase(torch, dev):
    """Phase 29: TimeSformer-HR (16 frames of 448², 12 divided space-time
    blocks of 12 heads of 64; ``python3 chip_smoke.py --phase 29`` runs it
    alone) served and trained on the card in bf16, both attentions of
    every block on K4's wgmma route. First K4 alone at the model's two
    calls (TSF_K4_SHAPES): ``compare_flash_kernels`` there (forward, di,
    dK/dV and dQ against the plain versions under the route's bf16 rule)
    and each kernel timed (``time_divided_k4``). Serving: the predictor
    with phase 9's redrawn biases and LayerNorms (the head as drawn), a
    seeded uint8 batch [8, 16, 252, 448, 3] through
    ``_make_forward(False)``: launches K1 1 and K4 fwd 24, all else 0;
    probabilities that spread; ms a batch and peak memory (read before any
    plain or reference forward); within SPREAD_SERVE_TOL of the forward on
    plain versions; the largest gap of the centred log-probabilities to
    the published forward in float32 (``tests/timesformer_reference.py``).
    Training: one ``make_train_step`` at B=8 on a noise batch: K4 fwd,
    dK/dV, dQ and di 24 each, the fused preprocess 2; the loss finite,
    every gradient finite and every attention's projections nonzero; ms a
    step and peak memory; then at TSF_PLAIN_BATCH clips the step against
    the plain step (VIVIT_TRAIN_TOL, query and key VIVIT_TEMPORAL_QK_TOL)."""
    import importlib.util

    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.ops import dequant_pad, preprocess
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        eval_preprocess)
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    spec = importlib.util.spec_from_file_location(
        "timesformer_reference",
        os.path.join(ROOT, "tests", "timesformer_reference.py"))
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)

    t_start = time.time()
    out = {"launches": {}}
    failed = []
    cfg = ExperimentConfig().override(TSF_OVERRIDES)
    T, L = cfg.data.num_frames, TSF_BLOCKS

    # -- K4 at the model's two calls
    out["compare"] = compare_flash_kernels(
        torch, dev, shapes=TSF_K4_SHAPES)["rows"]
    torch.cuda.empty_cache()
    out["k4_timing"] = time_divided_k4(torch, dev)

    # -- serving
    torch.cuda.reset_peak_memory_stats()
    pred = CollisionPredictor(cfg, None)
    if pred._fold_stride() != 1 or T != 16 or tuple(
            pred.model.pos_embed.shape) != (785, 768):
        raise SystemExit(f"fold stride {pred._fold_stride()}, T {T}, "
                         f"table {tuple(pred.model.pos_embed.shape)}")
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in pred.model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in pred.model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
    frames = torch.stack([
        torch.randint(12 * i, 256 - 16 * i, (T, *TSF_CONTENT, 3),
                      generator=g, dtype=torch.uint8)
        for i in range(VIVIT_BATCH)]).to(dev)
    forward = pred._make_forward(folded_stride=False)
    forward(frames)
    torch.cuda.synchronize()
    counters = zero_counters()
    probs = forward(frames)
    torch.cuda.synchronize()
    launches = expect_launches("timesformer serve", counters, K1=1,
                               K4_fwd=2 * L)
    out["launches"]["timesformer_serve"] = launches
    log(f"[timesformer serve] probs {probs.tolist()}")
    if tuple(probs.shape) != (VIVIT_BATCH, 3) or not bool(
            torch.isfinite(probs).all()):
        raise SystemExit(f"timesformer: bad probabilities {probs}")
    spread = float((probs.max(0).values - probs.min(0).values).max())
    if spread < SPREAD_MIN:
        failed.append(f"timesformer: probabilities too alike ({spread})")
    ms = median_ms(torch, lambda: forward(frames), warmup=2, iters=10,
                   queued=False)
    peak = torch.cuda.max_memory_allocated()
    with swapped(*flash_plain_swaps(),
                 (preprocess, "dequant_normalize_pad",
                  dequant_pad.dequant_normalize_pad_plain)):
        plain = forward(frames)
        torch.cuda.synchronize()
    err = max_err(torch, probs, plain)
    if not err <= SPREAD_SERVE_TOL:
        failed.append(f"timesformer: the forward disagrees with its plain "
                      f"version ({err})")
    P = {k: v.float() for k, v in pred.model.state_dict().items()}
    with torch.no_grad(), reference.float32_math():
        x = eval_preprocess(frames, cfg.augment, cfg.data.frame_size,
                            torch.float32, use_kernel="force")
        ref_logits = reference.logits(P, x, TSF_HEADS, 16)
    lp = torch.log(probs.double())
    lr = torch.log_softmax(ref_logits.double(), -1)
    gap = float(((lp - lp.mean(-1, keepdim=True))
                 - (lr - lr.mean(-1, keepdim=True))).abs().max())
    log(f"[timesformer serve] spread {spread:.4f}; vs plain max |Δprob| "
        f"{err:.3e} (tol {SPREAD_SERVE_TOL:.0e}); gap to the published "
        f"forward in float32 {gap:.4f}; {ms:.2f} ms a batch; peak "
        f"{peak / 2**30:.2f} GiB")
    out["serve"] = {"probs": probs.tolist(), "spread": spread,
                    "max_abs_err_vs_plain": err, "logit_gap_vs_reference": gap,
                    "ms": ms, "peak_bytes": peak}
    del pred, frames, forward, probs, plain, P, x, ref_logits
    torch.cuda.empty_cache()

    # -- training
    torch.cuda.reset_peak_memory_stats()
    model, state = create_train_state(cfg, torch.Generator().manual_seed(13),
                                      steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, cfg)
    batch = vivit_noise_batch(torch, dev, T, VIVIT_BATCH, 14, TSF_CONTENT)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_init = copy.deepcopy(state.optimizer.state_dict())

    def run(b):
        """One step on ``b`` from the initial weights and optimizer state."""
        model.load_state_dict(init)
        state.optimizer.load_state_dict(opt_init)
        state.step = 0
        _, m = step(state, *b, torch.Generator(device=dev).manual_seed(
            TRAIN_SEED))
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().float().clone()
                 for n, p in model.named_parameters()})

    counters = zero_counters()
    metrics, grads = run(batch)
    launches = expect_launches(
        "timesformer train", counters, K4_fwd=2 * L, K4_bwd_dKdV=2 * L,
        K4_bwd_dQ=2 * L, K4_bwd_di=2 * L, train_preprocess=2)
    out["launches"]["timesformer_train"] = launches
    if not math.isfinite(metrics["loss"]):
        raise SystemExit(f"timesformer: non-finite loss {metrics}")
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    attn = [n for n in grads if "attn." in n and not n.endswith(".key.bias")]
    zero = [n for n in attn if float(grads[n].abs().max()) == 0.0]
    log(f"[timesformer train] metrics {metrics}; {len(grads)} parameters; "
        f"non-finite {bad}; {len(attn)} attention parameters, zero {zero}")
    if bad or zero or len(attn) != 2 * 7 * L:
        failed.append("timesformer: a gradient is missing, non-finite or 0")
    del grads
    gen = torch.Generator(device=dev).manual_seed(7)
    step_ms = median_step_ms(torch, lambda: step(state, *batch, gen),
                             warmup=1, iters=TRAIN_TIME_ITERS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[timesformer train] {step_ms:.1f} ms a step of {VIVIT_BATCH} "
        f"clips; peak {peak / 2**30:.2f} GiB")

    small = tuple(t[:TSF_PLAIN_BATCH] for t in batch)
    metrics_s, grads_s = run(small)
    with swapped(*flash_plain_swaps()):
        plain_metrics, plain_grads = run(small)
    loss_err = abs(metrics_s["loss"] - plain_metrics["loss"]) / abs(
        plain_metrics["loss"])
    errs = rel_grad_errs(torch, grads_s, plain_grads, GRAD_FLOOR)
    qk = {n: e for n, e in errs.items()
          if ".query." in n or ".key." in n}
    worst = max(((n, e) for n, e in errs.items() if n not in qk),
                key=lambda kv: kv[1])
    worst_qk = max(qk.items(), key=lambda kv: kv[1])
    log(f"[timesformer train] {TSF_PLAIN_BATCH} clips, kernels vs plain: "
        f"loss rel {loss_err:.2e}; worst gradient {worst} (tol "
        f"{VIVIT_TRAIN_TOL:.0e}); query/key {worst_qk} (tol "
        f"{VIVIT_TEMPORAL_QK_TOL:.0e})")
    if (loss_err > VIVIT_TRAIN_TOL or worst[1] > VIVIT_TRAIN_TOL
            or worst_qk[1] > VIVIT_TEMPORAL_QK_TOL):
        failed.append("timesformer: the step disagrees with its plain version")
    out["train"] = {"metrics": metrics, "ms": step_ms, "peak_bytes": peak,
                    "plain_batch": TSF_PLAIN_BATCH, "loss_rel_err": loss_err,
                    "worst_grad_rel_err": worst, "worst_query_key": worst_qk}
    del model, state, step, batch, small, grads_s, plain_grads, init
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_start
    if failed:
        raise SystemExit(f"timesformer: {failed}")
    return out


def kernel_line(compare_rows, launches, timing):
    """One entry per kernel. ``launches`` is the sum over the main paths'
    runs (the serving forward and the training step of the flagship and of
    the scaled ViViT, predict's batch loop, the sliding forward, the
    Trainer's run, the reference checkpoint's forwards in float32 and
    bf16, the BatchNorm backbones' forwards and step, the other heads'
    forwards and steps, and phases 20 and 21's ranks summed: the DP step
    at world size 1 and on two ranks, the BatchNorm DP step, the DP
    Trainer, the TP step and evaluation; the bundles' bucket-8 calls; the
    attention view's call; ConvNeXt base's and large's forward and step,
    in bf16 and in float32 with ``fused_mlp=True``; the flagship's float32
    step; each counted from 0), with the split in ``launches_by_path``; ms,
    plain_ms, bound_ms and library_ms cover one pass over the stages (K1:
    one launch; K2 and K3: the 18 launches of one pass through the
    flagship's ConvNeXt blocks; K4: the 8 launches of one pass through the
    spatial blocks; ``K3 (wide)`` and ``K3 train (wide)``, bf16 on
    ``convnext_mlp_wide.cu``: the 3 launches of base's last stage at C =
    1024 and the 3 of large's at 1536, with ``convnext_mlp.cu`` on the same
    inputs as ``mma_sync_ms`` and the stock chain as ``stock_chain_ms``).
    ``K2 (hopper f32)``, ``K3 (wgmma f32)`` and ``K3 train (wgmma f32)`` are
    the Hopper kernels on float32 activations (the reference checkpoint's
    forward; K3 with ``fused_mlp=True``), each with the kernel it replaced
    there timed on the same inputs (``dwconv_cu_ms``, ``mma_sync_ms``);
    ``K2`` (``dwconv.cu``) and ``K3 (f32)`` (``convnext_mlp.cu``) are those
    kernels, timed on the same float32 inputs, ``dwconv.cu`` also on the
    Hopper kernel's bf16 inputs (``bf16_inputs_ms``). ``K2 wgrad (hopper
    f32)`` (the 18 launches of the flagship's float32 step, with
    ``dwconv_wgrad.cu`` on the same inputs as ``dwconv_wgrad_cu_ms``),
    ``K3 (wide f32)`` and ``K3 train (wide f32)`` (base's and large's last
    stages in float32, 3 + 3, ``convnext_mlp.cu`` as ``mma_sync_ms``) are
    phase 25's float32 training routes. ``K4 fwd (f32)``, ``K4 bwd dKdV
    (f32)`` and ``K4 bwd dQ (f32)`` are K4's float32 kernels (split
    products; phase 26's paths, 8 launches a pass), with the CUDA-core
    kernels timed on the same inputs as ``cuda_core_ms`` and the bound of
    the products the design issues as ``design_bound_ms``; ``K4 split`` is
    their split pass, one launch a forward and one a backward (16 a
    training step; ms and bound of the 8 forward and 8 backward launches;
    ``replaces`` names the forward's Pallas kernel, whose float32 operands
    it prepares for all three); the ``(d16)`` and ``(d16 f32)`` entries are
    head_dim 16's Hopper kernels (bf16 and float32, phase 27's paths:
    vivit_tiny's 2 launches a pass), with the kernels they replaced on the
    same inputs as ``mma_sync_ms`` and ``cuda_core_ms``, and ``K4 split
    (d16)`` their split pass. Every K4 kernel carries ``exp_floor_ms``, the
    least time of its exponentials on the special-function unit, beside
    its bound. Both K4 backward
    kernels carry the library's whole backward as library_ms: it is one
    call. ``K4 bwd di``
    is the backward's row kernel: in the JAX library di is jnp beside the
    two Pallas kernels (the line ``replaces`` names), not a kernel. ``train
    preprocess`` is the fused training preprocess (phase 28; no TPU
    kernel): its two launches at vivit_small's [8, 32, 189, 336, 3] → bf16,
    the chain as plain_ms, the bound of the function (the content read
    once) as bound_ms and the design's (read twice) as design_bound_ms."""
    csrc = "vision_collision_detection_tpu_torch/ops/csrc/"
    tpu = "vision_collision_detection_tpu/ops/"
    # K4's pallas_call sits in the JAX library the TPU wrapper calls
    lib = " (jax/experimental/pallas/ops/tpu/flash_attention.py:"
    meta = {
        "K1": ("dequant_pad", csrc + "dequant_pad.cu",
               tpu + "pallas_ops.py:81"),
        "K2": ("dwconv7x7", csrc + "dwconv.cu", tpu + "dwconv_pallas.py:78"),
        "K2 (hopper)": ("dwconv7x7_hopper", csrc + "dwconv_hopper.cu",
                        tpu + "dwconv_pallas.py:78"),
        "K2 (hopper f32)": ("dwconv7x7_hopper_f32", csrc + "dwconv_hopper.cu",
                            tpu + "dwconv_pallas.py:78"),
        "K2 wgrad": ("dwconv7x7_wgrad", csrc + "dwconv_wgrad.cu",
                     tpu + "dwconv_pallas.py:114"),
        "K2 wgrad (hopper)": ("dwconv7x7_wgrad_hopper",
                              csrc + "dwconv_wgrad_hopper.cu",
                              tpu + "dwconv_pallas.py:114"),
        "K2 wgrad (hopper f32)": ("dwconv7x7_wgrad_hopper_f32",
                                  csrc + "dwconv_wgrad_hopper.cu",
                                  tpu + "dwconv_pallas.py:114"),
        "K3": ("convnext_mlp", csrc + "convnext_mlp_wgmma.cu",
               tpu + "convnext_mlp_pallas.py:160"),
        "K3 (f32)": ("convnext_mlp_f32", csrc + "convnext_mlp.cu",
                     tpu + "convnext_mlp_pallas.py:160"),
        "K3 train": ("convnext_mlp_train", csrc + "convnext_mlp_wgmma.cu",
                     tpu + "convnext_mlp_pallas.py:160"),
        "K3 (wgmma f32)": ("convnext_mlp_wgmma_f32",
                           csrc + "convnext_mlp_wgmma.cu",
                           tpu + "convnext_mlp_pallas.py:160"),
        "K3 train (wgmma f32)": ("convnext_mlp_train_wgmma_f32",
                                 csrc + "convnext_mlp_wgmma.cu",
                                 tpu + "convnext_mlp_pallas.py:160"),
        "K3 (wide)": ("convnext_mlp_wide", csrc + "convnext_mlp_wide.cu",
                      tpu + "convnext_mlp_pallas.py:160"),
        "K3 train (wide)": ("convnext_mlp_train_wide",
                            csrc + "convnext_mlp_wide.cu",
                            tpu + "convnext_mlp_pallas.py:160"),
        "K3 (wide f32)": ("convnext_mlp_wide_f32",
                          csrc + "convnext_mlp_wide.cu",
                          tpu + "convnext_mlp_pallas.py:160"),
        "K3 train (wide f32)": ("convnext_mlp_train_wide_f32",
                                csrc + "convnext_mlp_wide.cu",
                                tpu + "convnext_mlp_pallas.py:160"),
        "K4 fwd": ("flash_mha_fwd", csrc + "flash_attention_fwd_wgmma.cu",
                   tpu + "flash_attention.py:96" + lib + "758)"),
        "K4 bwd dKdV": ("flash_mha_bwd_dkv",
                        csrc + "flash_attention_bwd_wgmma.cu",
                        tpu + "flash_attention.py:96" + lib + "1121)"),
        "K4 bwd dQ": ("flash_mha_bwd_dq",
                      csrc + "flash_attention_bwd_wgmma.cu",
                      tpu + "flash_attention.py:96" + lib + "1456)"),
        "K4 bwd di": ("flash_mha_bwd_di", csrc + "flash_attention_bwd.cu",
                      tpu + "flash_attention.py:96" + lib + "1664)"),
        "K4 split": ("flash_mha_split_f32",
                     csrc + "flash_attention_fwd_f32.cu",
                     tpu + "flash_attention.py:96" + lib + "758)"),
        "K4 split (d16)": ("flash_mha_split_f32_d16",
                           csrc + "flash_attention_fwd_f32.cu",
                           tpu + "flash_attention.py:96" + lib + "758)"),
        "train preprocess": ("train_preprocess",
                             csrc + "train_preprocess.cu",
                             "none: the JAX package leaves train_preprocess "
                             "(ops/preprocess.py) to XLA"),
    }
    # K4's other routes, each an entry of its own: float32 with head_dim 64
    # on the split-product Hopper kernels, head_dim 16 on its own Hopper
    # kernels (flash_d16.cuh) in the same files, bf16 and float32
    for kind, name, line in (("fwd", "flash_mha_fwd", "758)"),
                             ("bwd dKdV", "flash_mha_bwd_dkv", "1121)"),
                             ("bwd dQ", "flash_mha_bwd_dq", "1456)")):
        part = "fwd" if kind == "fwd" else "bwd"
        f32 = f"flash_attention_{part}_f32.cu"
        bf16 = f"flash_attention_{part}_wgmma.cu"
        for tag, suffix, src in ((" (f32)", "_f32", f32),
                                 (" (d16)", "_d16", bf16),
                                 (" (d16 f32)", "_d16_f32", f32)):
            meta[f"K4 {kind}{tag}"] = (
                name + suffix, csrc + src,
                tpu + "flash_attention.py:96" + lib + line)
    out = []
    for k, (name, src, replaces) in meta.items():
        rows = [r for r in timing if r["kernel"] == k]
        errs = [r["max_abs_err"] for r in compare_rows if r["entry"] == k]
        by_path = {path: counts.get(k, 0) for path, counts in launches.items()}

        def total(key):
            vals = [r.get(key) for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["per_forward"] for v, r in zip(vals, rows))

        by_ops = sum(r["bound_by"] == "operations" for r in rows)
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(errs), "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if 2 * by_ops > len(rows) else "bytes",
            "library_ms": total("library_ms")}
        # the kernel that still serves the other dtypes and widths, timed on
        # the same inputs
        for key in ("mma_sync_ms", "dwconv_cu_ms", "dwconv_wgrad_cu_ms",
                    "cuda_core_ms", "design_bound_ms", "exp_floor_ms"):
            if total(key) is not None:
                entry[key] = total(key)
        # K3 on float32 and on the split kernel: the stock chain on the
        # same inputs
        if total("stock_chain_ms") is not None and k in (
                "K3 (f32)", "K3 (wgmma f32)", "K3 (wide)", "K3 train (wide)",
                "K3 (wide f32)"):
            entry["stock_chain_ms"] = total("stock_chain_ms")
        # dwconv.cu, timed on float32 (its main path's), also on the bf16
        # inputs of its Hopper sibling
        bf16 = [r for r in timing if r["kernel"] == f"{k} bf16"]
        if bf16:
            entry["bf16_inputs_ms"] = sum(r["ms"] * r["per_forward"]
                                          for r in bf16)
        out.append(entry)
    for r in out:
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise SystemExit(f"non-finite timing in {r}")
    return out


# the phases that run alone: ``python3 chip_smoke.py --phase N``
ALONE = {"26": lambda: float32_vivit_phase, "27": lambda: vivit_tiny_phase,
         "28": lambda: fused_preprocess_phase, "29": lambda: timesformer_phase}


def phase_main(n) -> int:
    """``python3 chip_smoke.py --phase N``: phase 26 (the float32 ViViT),
    27 (vivit_tiny), 28 (the fused training preprocess) or 29
    (TimeSformer-HR) alone, with the kernels built and TF32 off as
    ``main`` sets them; its record in ``chiprun_out/phaseN.json``."""
    import torch

    if n not in ALONE:
        print(f"chip_smoke: --phase takes one of {sorted(ALONE)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    out = ALONE[n]()(torch, torch.device("cuda"))
    log(f"[phase {n}] {out['phase_s']:.1f} s")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"phase{n}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(phase_main(sys.argv[2] if len(sys.argv) > 2 else ""))
    sys.exit(main())
