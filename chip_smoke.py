#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``puzzlelib_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines and ending the run with a non-zero exit when
it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the hand-written kernels from ``puzzlelib_tpu_torch/csrc``
   with ``nvcc`` into ``build/kernels`` and prints the seconds it took and
   the compiler's register / spill report;
   checkinstall: ``puzzlelib_tpu_torch.checkinstall.main()`` on the card,
   with the counters reset just before and read just after: K0 (the
   install probe) launched once and exact, the K1 f32 GEMM probe within
   its bound; K0 then timed against ``torch.mul`` in 5 alternating turns of
   200 calls, the medians printed;
3. K1 (GEMM) against its plain PyTorch version at the VGG-16 fc shapes
   (M = 32) in bf16, f16 and f32, a ragged 100 x 200 x 60, the transformer
   slice's three products in bf16 and f16 (``tools/transformerslice.py``
   GEMMS) and 8192^3 in bf16, each on the kernel its shape routes to (wgmma
   where TMA can describe a bf16 or f16 product), with its second call bit
   for bit, timed beside the WMMA kernel on the same operands, in turns,
   and beside cuBLAS, with whether wgmma beat WMMA printed;
   K1-int8 against its plain version (an f64 product, exact) with exact
   int32 equality and a bit-equal second call at each distinct int8
   product of the VGG-16 int8 engine at batch 32 (INT8_SHAPES: the 13 convs
   as im2col products, conv1_1's K = 27 padded to 32, and fc6, fc7, fc8 at
   M = 32) and two ragged shapes (INT8_RAGGED: K off a multiple of 16, on
   the WMMA kernel, and K a multiple of 16, on wgmma), each through
   ``matmulNT`` on a pre-laid-out B^T on the kernel its shape routes to,
   timed in turns beside the WMMA kernel on the same operands (which must
   give the same int32 values) and ``torch._int_mm``, the per-call
   transpose of ``matmul(a, b)`` apart, each bound at the function's own K;
   then the request's 16 products on both kernels and whether the wgmma
   kernel met its landing rule (printed, not a gate);
4. K2 (Winograd conv), K2-bwd (K2 as the stride-1 bwd-data,
   ``winograd.dataGrad``) and K3 (Winograd bwd-filter) against their plain
   versions and against an f32 library reference with TF32 off
   (``F.conv2d``, ``torch.nn.grad.conv2d_input``, ``conv2d_weight``), at
   each distinct Winograd-eligible VGG-16 conv at batch 32; each kernel and
   its library call also timed on channels-last operands, as the training
   path hands them over, and each kernel's second call and its call on
   those operands must give the same bits as its first;
5. the serving slice: VGG-16 at full width in bf16, random He weights from
   ``np.random.seed(0)``, 128 seeded images through
   ``Calculator(net, batchsize=32).calcFromHost``.  The launch counters are
   reset just before and read just after that run (every K1 launch on
   wgmma, here and in [train] and [engine-bf16]; in [transformer] and
   [transformer-train] all but the head's; every K4 launch on its wgmma
   kernel in [transformer], [transformer-train] and [engine-flash]); the
   output is checked for shape, finiteness and softmax rows, and fc8 of the
   first batch against the same f32 weights run on the library route;
6. the training slice: the same net without its SoftMax, in bf16, trained by
   ``Trainer(batchsize=32).trainFromHost`` with ``CrossEntropy`` and
   ``MomentumSGD`` in global state on 128 seeded images and labels (4
   steps).  The counters are reset just before and read just after the
   counted run; every step's loss must be finite, every variable must have
   changed through the optimizer's flat buffer, the first step's gradients of
   six layers must agree with the same step on the bf16 library route, and
   the 4 losses with the library route's;
7. K4 (flash-attention forward) against its plain version in bf16, ``out``
   and ``lse``, at the transformer slice's shape, at the long sequences of
   ``puzzlelib_tpu/benchmarks/attnspeed.py``, at seqQ != seqK (causal,
   the bottom-right offset), at the flash engine's shape and at head dim
   128: the wgmma kernel at the block height the wrapper routes each shape
   to, with its second call bit for bit, and its other block height and
   the first mma.sync kernel (the yardstick) held to the plain version too;
   all three timed in turns, beside ``scaled_dot_product_attention``, with
   whether the wgmma kernel met its landing rule against the yardstick
   printed, and each kernel instance's registers, spills and shared memory
   from the build's ptxas report (a spill in a wgmma instance fails);
8. the transformer serving slice of ``tools/transformerslice.py``: the IMDB
   transformer classifier of ``testlib/transformertrain.py`` at full width
   (vocab 20000, seq 80, emb 128, 4 heads, 2 layers, 2 classes) in bf16 with
   ``attnAlgo="flash"``, random weights from ``np.random.seed(0)``, 256
   seeded token rows through ``Calculator(net, batchsize=64).calcFromHost``.
   The counters are reset just before and read just after that run; the
   logits are checked for shape and finiteness, and the first request's
   against the same f32 weights on the library route;
9. K5a and K5b (the flash-attention backward: dq; dk and dv) against their
   plain version ``backwardPlain`` in bf16 at K4's shapes and at seqQ 80 >
   seqK 48 causal (rows that see no key), beside
   the backward of ``scaled_dot_product_attention``; each kernel alone and
   the whole ``flash.backward`` are timed, the rest of the whole (the delta
   pass and the wrapper's set-up) printed as their difference;
10. the transformer training slice of ``tools/transformerslice.py``: the
   same classifier in bf16 trained by ``Trainer(batchsize=64)`` with
   ``Adam(alpha=1e-3)`` in global state and ``CrossEntropy(maxlabels=2)``
   over 256 seeded token rows and labels (4 steps).  The counters are reset
   just before and read just after the counted run; every step's loss must
   be finite, every variable must have changed through the optimizer's flat
   buffers, the first step's gradients of five variables must agree with
   the library route's backward (composed attention, cuBLAS) on the same
   forward, and the 4 losses with the library route's;
11. the int8 engine slice of ``tools/engineslice.py`` ([engine-int8]):
   VGG-16 at full width without its SoftMax, f32 He weights from
   ``np.random.seed(0)``, calibrated by ``DataCalibrator(batchsize=16,
   algo="minmax")`` on 64 seeded images, built by ``buildEngine(...,
   dtype="int8")`` on the card into a temporary directory under ``build/``,
   loaded back by ``Engine`` and served 4 requests of 32 through
   ``Calculator(engine, batchsize=32).calcFromHost``.  The counters are
   reset just before and read just after that run (64 K1-int8, all 64 on
   wgmma, no float K1, no K2); the graph must record
   ``puzzlelib::matmul_nt`` 16 times; the engine file must hold at most 1.1
   x its int8 weights, scales and biases; the first request's logits must be
   finite and within cosine 0.99 of the same f32 weights on the library
   route;
12. the bf16 engine of the same net ([engine-bf16]): built, loaded and
   served the same way, with 40 K2 and 12 K1 launches, and its logits within
   1e-3 relative L2 of the eager bf16 ``Calculator`` on a clone of the net;
13. the flash engine ([engine-flash]): a float-input attention net
   (LayerNorm, MultiHeadAttention at emb 256, 4 heads) whose "auto" core is
   flash in bf16 on the card at seq 1024, built as a bf16 engine (K4 in its
   graph as ``puzzlelib::flash``), loaded back and served 4 requests of 8
   with the counters reset just before and read just after (4 K4, all on
   the wgmma kernel, nothing else), its output within 1e-3 of the eager
   bf16 net's;
14. [transformer-train] (phase 10) runs the hand route a second time from
   the same start and fails unless the losses and the embedding gradient
   repeat bit for bit;
15. P3 ([P3-roofline], the roofline probe's streaming ``x + 1``) bit-equal
   to its plain version on 64 Mi bf16 values, and in f16, f32 and a ragged
   length, beside ``torch.add`` (5 alternating turns of 200 calls, the
   medians printed);
16. P2 ([P2-phasesplit], the strided-copy probe's phase-slab copy) bit-equal
   to its plain version at the probe's shape, VGG-16's largest activation at
   batch 1 and a ragged one;
17. P1 ([P1-tapdot], the tap-dot probe's direct conv), its wgmma kernel and
   the first mma.sync kernel (the yardstick, through ``tapdot._launch``),
   each within 5e-3 relative L2 of its plain version and within the probe's
   5e-2 of the f32 conv at the probe's three shapes and VGG-16's conv2_2 and
   conv5_2 at batch 32, and two ragged shapes (one f16); at the five shapes
   both kernels, cuDNN and K2 on the same channels-last operands timed in
   turns (K2 also on NCHW ones), with P1's layout pass timed apart; each
   instance's ptxas registers, spills and shared memory (a spill in a
   wgmma instance fails), and whether wgmma beat mma.sync at every shape;
18. the measurement path ([measure]): the probe scripts and the benchmarks
   (``gemmspeed``, its ``--kernel-rate`` and its ``--tune`` race at 1024^3
   and 4096^3, ``kernelspeed``, ``convspeed`` and its ``--chain`` on
   VGG-16's conv3_2, each racing the conv first, ``attnspeed``, which
   records its winners) run as a user runs them, with every counter reset just
   before and read just after; each of P1-P3 and K1-K5b must have run, and
   every P1 launch on the wgmma kernel;
19. the CNN training slices of ``tools/cnnslice.py``, after phase 10.
   [lenet]: K1 held to its plain version at LeNet's two products at batch
   128 (f32 and bf16); LeNet in f32 trained 8 steps of 128 by
   ``Trainer.trainFromHost`` with ``MomentumSGD(0.01, 0.9)`` in global
   state, then ``Validator.validateFromHost`` over 1024 images, on the hand
   route and the library route; the K1 launches of each counted run (2 a
   step, 2 a validated batch, on the f32 kernel), the losses within 1e-4
   of the library route's, the validation errors equal; 5 runs of each
   route in turns; one bf16 run with 8 K1 launches on wgmma (800 -> 1024)
   and 8 on WMMA (1024 -> 10);
20. [nin-cifar]: the CIFAR-10 NIN of ``testlib/cnncifar10nin.py`` in f32,
   with ``hooks.WeightDecay(1e-4)`` and its two dropouts (draws reseeded at
   each run), trained and validated the same way; no hand-kernel launch;
   the losses against the library route's, two validations the same bits;
21. [nin]: the ImageNet NiN (``models/nets/nin.py``) in bf16 at batch 128,
   He weights from ``np.random.seed(0)``: 4 requests through ``Calculator``
   (logits of the first within 5e-2 of the same f32 weights on the library
   route), then without its SoftMax 4 training steps with ``CrossEntropy``
   and ``MomentumSGD(1e-4, 0.9)`` in global state (the first step's dW of
   conv3 and conv4-1024 on the hand kernels within 5e-2 of the library's
   backward on the same forward; the losses within 5e-2 of the library
   route's); each of conv3 and conv4-1024 must show one K2 forward a
   request, and one K2 forward, one K2 bwd-data and one K3 a step (counted
   inside each layer's own calls); then K2, K2-bwd and K3 at those two
   convs' shapes against their plain versions, and timed on channels-last
   operands against cuDNN in 5 alternating turns;
22. the fused step (``puzzlelib_tpu_torch/fused.py``: the eager step
   recorded once as a CUDA graph and replayed), [fused-transformer-train]:
   the transformer training slice through ``FusedTrainer(batchsize=64,
   stepsPerDispatch=4)``, 4 steps with the counters reset just before and
   read just after (the eager route's launches), every variable a view of
   the flat buffers and changed; with ``stepsPerDispatch=1`` the losses
   within 5e-2 of the eager ``Trainer``'s from the same start and batch
   order, and a second run bit-equal (losses and embed.W's last gradient);
   one recording per shape and none in steady state; rows/s of the fused
   and eager hand routes over 16 steps (1024 seeded rows) in 5 runs in
   turns, and each one's idle share in one run under ``torch.profiler``,
   whose device events by kernel name must count what the counters count;
23. [fused-transformer-serve]: ``FusedCalculator(batchsize=64)`` over the
   4 requests of [transformer], its launches as [transformer]'s and as the
   profiler's device events, the logits within 5e-2 of the eager hand
   route's, one recording; rows/s and idle shares fused and eager;
24. [fused-cnn]: the three nets of phases 19-21 through ``FusedTrainer``
   and ``FusedValidator``: LeNet (K1 as eager counts it, losses within 1e-4
   of eager, equal validation errors), the CIFAR-10 NIN (at learning and
   momentum rate 0, set between calls with no new recording, three steps
   on one batch keep the weights and give three losses, one per dropout
   mask, the same again from the same seed; the rates set back move the
   weights; equal validation errors; whether a replay draws what the eager
   step draws from the same generator state, printed), the ImageNet NiN
   (one K2, K2-bwd and K3 a step on each of conv3 and conv4-1024, counted
   inside each layer, losses within 5e-2 of eager); the profiler's device
   events of LeNet's and the NiN's fused runs held to the counters; images/s
   fused and eager in 5 runs in turns;
25. [resnet50]: ResNet-50 (``tools/resnetslice.py``) in bf16 at batch 32,
   He weights from ``np.random.seed(0)``: 4 requests through ``Calculator``
   and 12 steps through ``Trainer`` (``MomentumSGD(0.01, 0.9)`` in global
   state) on the hand and library routes and through ``FusedTrainer`` /
   ``FusedValidator`` / ``FusedCalculator``: one K2 a request and one K2,
   K2-bwd and K3 a step on each of the 13 convs ``winograd.applicable``
   takes (counted from the net, inside each conv), one K1 (fc1000); logits,
   losses and the first step's running stats within 5e-2 of the library
   route's; the first step's backward of one forward, every variable's
   gradient, within 5e-2 of the library's or no farther than the library's
   own from the loss gradient one bf16 ulp apart; the 12 steps' running
   stats within 5e-2 or no farther than the library route's own from the
   input one bf16 ulp apart; fused losses and running stats against
   eager's (the first loss bit-equal), one recording, a second fused run
   the same bits, a ``FusedCalculator`` replay after more training equal to the eager
   ``Calculator``; images/s of each route in 5 runs in turns, idle shares
   under the profiler, ``netspeed`` (training with ``--profile``: the
   per-layer table of ``benchmarks/layerprofile``), and K2, K2-bwd and K3
   at its three Winograd shapes against channels-last cuDNN;
26. [unet]: U-Net (``tools/unetslice.py``) in bf16 at batch 4 on 1 x 512 x
   512 inputs, He weights from ``np.random.seed(0)``: 4 requests served
   with the sigmoid, 8 steps trained without it (``BCE``,
   ``MomentumSGD(1e-3, 0.99)`` in global state) and 16 images validated,
   on the hand, library and fused routes; one K2 a request or validated
   batch and one K2, K2-bwd and K3 a step on each of the 15 convs
   ``winograd.applicable`` takes (counted from the net, inside each conv,
   and by the profiler in fused runs), no K1; the first request's logits
   and sigmoid outputs each within 5e-2 of the same f32 weights on the
   library route; every variable's first-step gradient within 5e-2 or its
   control; the losses within 5e-2 of the library route's and growing on
   neither route; the hand and fused runs twice the same bits, the fused
   first loss that of eager; on the library route's trained weights, the
   validation error no farther from the library route's than the library
   route's own from those weights in f32 or from its input one bf16 ulp
   apart; images/s of each route in 5 runs in turns, idle shares, the peak
   of device memory, and K2, K2-bwd and K3 at each of the 15 convs against
   channels-last cuDNN;
27. [inception]: Inception-BN and Inception-v3 (``tools/inceptionslice.py``)
   in bf16 with f32 batch norms at batch 32: 4 requests each through
   ``Calculator`` on the hand and library routes and ``FusedCalculator``;
   one K1 a request on each net and one K2 a request on each of
   Inception-BN's two Winograd convs; logits within 5e-2 of the same f32
   weights on the library route; images/s in 5 runs in turns; K1 at both
   ``fc1`` shapes and K2 at Inception-BN's 14 x 14 shape against cuBLAS and
   cuDNN;
28. [imdb-rnn]: the three IMDB sentiment nets (``tools/sequenceslice.py``:
   LSTM, BiLSTM, 1-d CNN) at full width in f32, ``Adam(1e-3)`` in global
   state and ``BCE``: 4 steps of 32 on the hand, library and fused routes,
   one K1 a step on each ``Linear`` head (none on the library route); the
   losses within 5e-2 of the library route's, fused within 5e-2 of eager's,
   the hand route twice the same bits; ``Validator`` and ``FusedValidator``
   over 128 rows, one readback a call, the errors equal; rows/s of each
   route in 3 runs in turns, the idle share of a profiled fused and eager
   run with K1's launches held to the profiler's device events; K1 at the
   four head products against cuBLAS;
29. [w2l]: Wave2Letter at full width (161 features, 29 labels, 106.8 M
   parameters) on 8 x 161 x 1600 frames a batch: f32 and bf16, 4 requests
   served and 4 steps trained with CTC on the loop of
   ``testlib/ctctrain.py``; the bf16 scores within 5e-2 relative L2 of
   f32's; the bf16 losses within 5e-2 of f32's and falling at every step;
   CTC on the card within 1e-4 of ``hostCTCLoss`` in f64; a second run the
   same bits (or the op that does not repeat named and the runs held within
   5e-2); images/s served and trained;
30. [zoo-vision]: MiniYolo (448 x 448, batch 16), OpenPose COCO and OpenPose
   MPI (368 x 368, batch 8) at full width in bf16 (``tools/zooslice.py``),
   He weights from ``np.random.seed(0)``: 4 requests each through
   ``Calculator`` on the hand and library routes and ``FusedCalculator``;
   one K2 a request on each of the 12, 15 and 12 convs
   ``winograd.applicable`` takes (counted from the net and inside each
   conv) and on MiniYolo one K1 a request inside each of fc25, fc26 (on
   wgmma) and fc27 (on WMMA), the same fused and in the profiler's device
   events; the first request's outputs within 5e-2 relative L2 of the same
   f32 weights on the library route, the fused outputs equal to the eager
   ones; images/s of each route in 5 runs in turns; K2 at each net's
   Winograd convs against channels-last cuDNN and K1 at fc25-fc27 against
   cuBLAS;
31. [sentinet]: SentiNet at its preset's widths (vocabulary 20000,
   sentences of 100 + 2 x 4, embeddings of 300, branches 3, 4, 5 of 100
   maps) in f32 on 2048 seeded sentences: ``presets.sentinet.train(...,
   saving=False)`` on the hand and library routes (3 epochs, ``AdaDelta``,
   ``CrossEntropy``; the head raced against cuBLAS by its
   ``optimizeForShape`` before the counted runs, so that the preset's own
   call launches nothing), K1 on the head once a step and a validated batch,
   the epochs' training errors within 1e-4 of the library route's and
   falling, equal validation errors; each of the six new optimizers in
   global state, 4 steps of 64 on the hand, library and fused routes, the
   hand losses within 1e-4 of the library's, the fused ones equal to
   eager's and the same bits again, one recording; rows/s; K1 at the
   head's product against cuBLAS;
32. [costs]: the seven new costs on the card against the same call on the
   CPU within 1e-5, in f32; ``Multi`` through ``FusedValidator`` (the eager
   path) and ``SVM`` through a recorded one, ``mostProb`` equal to the eager
   Validator's;
33. [segnet]: SegNet (``tools/segslice.py``: VGG-16's encoder, its mirrored
   decoder through ``MaxUnpool2D`` and the encoder's pooling masks, 12
   classes, a trailing ``Cast`` to f32) in bf16 with f32 batch norms at
   batch 4 on 3 x 360 x 480, He weights from ``np.random.seed(0)``: 4
   requests through ``Calculator`` and 4 steps through ``Trainer``
   (``CrossEntropy``, ``MomentumSGD(LEARN_RATE, 0.9)`` in global state) on
   the hand and library routes and through ``FusedCalculator`` /
   ``FusedTrainer``: one K2 a request and one K2, K2-bwd and K3 a step on
   each of the 20 convs ``winograd.applicable`` takes (counted from the
   net, inside each conv, and by the profiler in fused runs); on the first
   request, the encoder's output within 5e-2 relative L2 of the same f32
   weights on the library route and the scores within 5e-2 of the library
   route's bf16 forward on the hand route's pooling masks (the scores'
   distance from f32, which bf16's flipped masks set, printed with its
   controls); the hand route's losses within 5e-2 of the library
   route's and falling on both; the hand run twice the same bits; fused
   outputs equal to eager's, the fused first loss eager's and the rest
   within 5e-2; images/s of each route in 5 runs in turns, idle shares, and
   K2, K2-bwd and K3 at each of SegNet's 8 conv shapes against
   channels-last cuDNN, counted for each of the 20 convs;
34. [alexnet]: AlexNet (``tools/alexnetslice.py``: Caffe's
   ``bvlc_alexnet``, two ``CrossMapLRN`` and grouped convs) in f32 at
   batch 128 on 3 x 227 x 227, and [c3d]: C3D (``tools/c3dslice.py``: eight
   ``Conv3D`` and five ``MaxPool3D``) in bf16 at batch 16 on 3 x 16 x 112 x
   112 clips, He weights from ``np.random.seed(0)``: 4 requests through
   ``Calculator`` and 4 steps through ``Trainer`` (``CrossEntropy``,
   ``MomentumSGD(LEARN_RATE, 0.9)`` in global state) on the hand and
   library routes and through ``FusedCalculator`` / ``FusedTrainer``: one
   K1 a request and a step on each Linear (AlexNet: ``gemmF32``; C3D: fc6
   and fc7 on wgmma, fc8 on WMMA), counted from the net, inside each Linear
   and by the profiler in fused and eager runs, none on the library route;
   the first request's scores within 1e-4 (AlexNet, TF32 off) of the
   library route or within 5e-2 (C3D) of the same weights in f32 on the
   library route; the hand route's losses within the same bound of the
   library route's and falling on both; the hand run twice the same bits;
   fused outputs equal to eager's, the fused first loss eager's and the
   rest within 5e-2; images (clips) / s of each route in 5 runs in turns,
   idle shares, and K1 at the three Linears' shapes against cuBLAS;
35. [layers]: the glue, upsampling and unpooling modules, the LRN family,
   ``SubtractMean``, ``LCN``, ``SpatialTf``, ``GroupLinear``, ``Penalty``,
   ``NoiseInjector``, ``Deconv1D`` / ``Deconv3D``, the 3-d pools and the
   1-d pools' backward one by one (``tools/layerslice.py``, at SegNet's,
   AlexNet's and C3D's maps at a quarter of their batches, and 16 MiB
   shapes), forward and backward on the
   card and on the CPU on the same inputs, in each type the module takes:
   the modules that only move data give the CPU's bits, the others fall
   within the twins' tiers; a second card run gives the same bits;
36. [moe]: the MoE trunk of ``testlib/pipelinemoe.py``
   (``tools/moeslice.py``: a ``Pipeline`` of 4 ``Graph`` stages, each
   Linear(64, 64), tanh and a residual ``SwitchMoE`` of 4 Linear(64, 64)
   experts at capacity factor 2, then a ``Slice`` of 10 logits) in f32 at
   batch 128 on seeded rows of the digits' shape, ``MomentumSGD(0.05,
   0.9)`` in local state: 4 requests and 4 steps on the hand, library and
   fused routes; K1 once a forward inside each of the 20 Linears (counted
   from the net, inside each Linear and by the profiler), none on the
   library route; scores and losses within 1e-4 of the library route's,
   fused within 1e-4 of eager's, the hand run twice the same bits;
   ``functionalize(stage 0)`` with each stage's weights bit-equal to that
   stage; a run under global state with the local run's losses; rows/s,
   idle shares, K1 at the two shapes against cuBLAS;
37. [graph-pass]: ``toGraph`` of ResNet-50 in bf16 at batch 32 beside the
   Sequential, 4 requests and 4 steps each on the hand route: the
   Sequential's launches (13 Winograd convs, fc1000), scores bit-equal,
   losses within 5e-2;
38. [rbm]: ``RBM(784, 500)`` in f32 at batch 128 (``tools/rbmslice.py``),
   20 CD-1 and 20 PCD steps under ``MomentumSGD``: the reconstruction error
   falls, a second run gives the same bits, one CD-1 gradient within 1e-5
   of an f64 numpy step on the card's draws;
39. [vgg-avg]: VGG-16 with average pooling in bf16, 4 requests of 32 on the
   hand and library routes: 10 K2 and 3 K1 a request, outputs within 5e-2
   of the library route's;
40. [auto]: the measured per-shape dispatch, ``Config.convAlgo = gemmAlgo =
   "auto"``: the tables emptied, ``optimizeForShape`` races VGG-16 bf16 at
   batch 32 (10 Winograd convs, 3 directions each, fc6-fc8), U-Net bf16 at
   batch 4 on 512^2 (15 convs), AlexNet's fc6-fc8 in f32 at 128, the MoE
   trunk's products and the transformer's attention at its slice shape and
   at (4, 8, 2048, 64); one line a key with the hand kernel's and the
   library's ms and the choice, which must follow them (hand below 0.97x
   for convs and attention, strictly faster for a product); the same races
   again, the same choice wherever the first gap passed 10 %; then VGG-16
   and U-Net serve 4 requests and train 4 steps under "auto", eager and
   fused, each kernel launched as many times as the table's hand choices
   ask, scores and losses within 5e-2 of the library route's; one forced
   change of a conv's choice, which the fused trainer records anew; images/s
   of the hand, library and measured routes in 5 runs in turns.  The
   races' launches fall outside the counted runs.
41. [data]: the data path from raw files to trained nets, in a temporary
   directory it removes: MNIST's four idx files (60000 + 10000 images),
   CIFAR-10's ``cifar-10-python.tar`` (5 x 10000 + 10000) and IMDB's
   ``imdb.npz`` (25000 + 25000 reviews up to 2494 words) with its 88584-word
   index, written from a seed (``tools/dataslice.py``), then parsed by the
   loaders' parse steps without a cache (host seconds and rows/s; whether
   ``h5py`` imports; the cache is held by the CPU twins): MNIST's and
   CIFAR-10's arrays equal to ``dataslice``'s own computation from the
   bytes, bit for bit; IMDB's at 20000 words and 80 tokens (50000, 80)
   int32 in [0, 20000), a second parse under the same seed (in a process
   of its own, beside the card's work) the same bits.
   LeNet f32 on ``cnnmnistlenet``'s recipe, one epoch over ``data[:60000]``
   in chunks of 10000, straight into ``trainFromHost`` and through a
   4-thread ``Serial`` with the identity ``Transformer`` preparing the next
   chunk: the same step losses bit for bit, K1 twice a step on each, a
   held-out error of ``data[60000:]`` at most 0.10.  The CIFAR-10 NIN on
   ``cnncifar10nin``'s recipe over 25000 standardized images in chunks of
   5000, shifted by ``dataslice.ShiftAugment`` on 4 threads of a
   ``Serial`` and inline on the main thread: finite losses, no hand-kernel
   launch, images/s and the card's idle share of each.  The IMDB LSTM of
   ``rnnimdbtrain`` on the first 256 parsed rows, 8 steps of 32 of
   ``_imdb``'s Adam and BCE: one K1 launch a step at its head, finite
   losses.
42. [ckpt]: checkpoints and blueprints on the card, run right after the
   serving slice (5).  The card's machine has no ``h5py``, so ``save`` and
   ``load`` take an open handle, a ``MemoryStore`` of numpy arrays
   (``puzzlelib_tpu_torch/hdf.py``; the HDF5 file layer is held by the CPU
   twins).  The served VGG-16
   bf16 is saved into it, rebuilt from ``json.loads(json.dumps(
   net.getBlueprint(), sort_keys=True))`` through ``BlueprintFactory``,
   set to bf16 and loaded: every variable on the card, bit-equal to the
   served net's; the rebuilt net serves the 4 requests with the counters
   reset, 12 K1 (all on wgmma) and 40 K2 launches, its output bit-equal to
   the served net's; the seconds of save, rebuild and load and the MB
   moved printed.  LeNet f32 under ``MomentumSGD(0.1, 0.9)`` in global
   state (``testlib/resumetrain.py``'s flow): 8 steps of 128, the net and
   the optimizer saved, 8 more (the reference); a fresh LeNet from the
   blueprint and a fresh optimizer in global state load both and take the
   same 8 steps: losses and variables bit-equal to the reference, every
   variable's and state's address kept across the load, K1 twice a step.
   The same through ``FusedTrainer``, whose fresh trainer records its CUDA
   graph before the load: no new recording after it.
43. [testlib]: the last nine ``testlib`` counterparts
   (``puzzlelib_tpu_torch/testlib``), each through its own entry point,
   right after [data], with the counters reset just before each run and
   read just after: each kernel's launches (a kernel the script does not
   reach must launch no time), the script's printed errors, accuracy or
   rates, the wall seconds, and the card's idle share of the run (or of a
   shorter run of it: an epoch, 10 CTC steps) under the profiler, its
   launches held to the device events.  The digits scripts train on
   ``dataslice.digits`` (the card's machine has no scikit-learn):
   ``gradientcheck.main()`` (median relative error below 1e-2, no hand
   kernel), ``digitslenet`` 15 epochs (accuracy >= 0.97, K1 in its
   Linears), ``digitsreal``'s tied autoencoder 40 epochs (MSE below 0.01,
   K1 twice a step: the encoder's forward product and the decoder's
   data-gradient product, which is untransposed; the decoder's transposed
   forward product on the library) and LSTM 40 epochs (accuracy >= 0.95),
   ``digitsnin`` 20 of its 300 epochs at 11 steps a dispatch (the train
   error falls; cuDNN runs its convs); ``encodertrain`` 2 epochs of
   [data]'s 70000 MNIST images (K1 twice a step, as the autoencoder's; the
   error falls); ``normfilters.normalize`` on a seeded 3 x 480 x 640
   image, held to the CPU within 1e-5; ``ctctrain.main(200)`` and its gate
   (the last NLL below 40 % of the first; cuDNN's 1-d convs and the host
   CTC loops, no hand kernel); ``transformertrain`` one epoch of [data]'s
   IMDB rows on the "xla" route in f32 (no K4 / K5) and on the "flash"
   route in bf16 (K4, K5a and K5b launched); ``optimizenet.main(16,
   looplength=3)`` in bf16: K2, K2-bwd and K3 10 a step and K1 3 a step,
   the eager and fused seconds a step printed.
44. [convert]: the converters on the card, run right after [ckpt] on the
   served VGG-16 bf16 and its 4 requests (the card's machine has no
   ``h5py``: every import goes into a ``MemoryStore``, which refuses a
   second dataset of a name, as ``h5py`` does).  VGG-16's weights (the f32
   of its bf16 values, exact) written by ``tools/convertslice.py`` as a V1
   ``VGG_ILSVRC_16_layers.caffemodel`` (the published file's layout: enum
   types, num / channels / height / width blobs, biases (1, 1, 1, N)),
   parsed (``loadNetParameter``), imported (``js2hdf``), loaded
   (``loadVGG(store, "16")``, then ``calcMode(bf16)``) and served: output
   bit-equal to the served net's, 40 K2 and 12 K1 (12 on wgmma).  The same
   through an MXNet ``.params`` and ``-symbol.json`` (``readHeader`` /
   ``readData`` / ``readKeys``, ``buildHdf``).  ResNet-50 bf16 from
   ``resnetslice.build`` with seeded running stats, written in He et al.'s
   new-format layout (BatchNorm's stats times a scale factor of 4, Scale,
   InnerProduct), imported, loaded (``loadResNet(store, "50")``) and
   served: bit-equal, 52 K2 and 4 K1.  Both nets exported to ONNX from the
   card and parsed back: VGG-16's 41 nodes by type and 32 initializers,
   ResNet-50's counts as ``convertslice.onnxCounts`` derives them, every
   initializer the bytes of ``gpuarray.get`` of its variable.  Then
   ``benchmarks/enginespeed`` on the NiN at batch 128 in bf16 and int8
   (eager and ``Engine.many`` over 8 distinct batches).  Each file's MB and
   the seconds and MB/s of its write, parse, import, load and export are
   printed; the files go to a directory under ``build/`` and are deleted.
45. [engine-driver], right after [engine-flash]: the native host driver
   (``converter/engine/src/engine_driver.cpp``, a libtorch C++ program whose
   ``g++`` compile [build] starts beside the kernels' ``nvcc`` runs) runs
   the three engines of phases 11-13 from their ``.program`` and
   ``.weights`` files, each in a process of its own on its phase's first
   request: the output ``.npy`` bit-equal to ``Engine``'s for that request,
   and each custom operator launched a run as many times as the program has
   nodes of it (16 ``matmul_nt``; 10 ``winograd_conv2d`` and 3 ``matmul``;
   1 ``flash`` and the attention net's ``matmul`` nodes).  The driver's
   program load, its first (cold) run and the median of its next runs are
   printed beside ``Engine``'s calls on the same request.
46. [grid], right after [testlib]: data parallelism on the one card.  (a)
   ``testlib/multigpumnist.py``'s recipe (``multigpumnist.train``, one
   epoch, through ``tools/gridslice.py``'s ``mnistNode``) on two nodes of
   ``runGrid(..., devices=[0, 0])``, which share card 0 and so run over
   gloo: the first 12800 rows of [data]'s parsed MNIST, 100 steps of 64 a
   node (a global batch of 128), 2000 rows validated.  The parent first
   runs ``gridslice.oracle``: the same seed and, at each step, the rows the
   two nodes take together, as one batch of 128.  The nodes' final weights
   must be bit-equal, ``meanValue`` must give both the same errors, the
   weights after step 1 and after step 100 within 1e-5 of the oracle's (of
   max(1, max |w|)), the first 10 step losses (the nodes' mean) within
   1e-4 relative of the oracle's, and each node's K1 launches the oracle's
   2 a step times 100.  The largest relative gap of the 100 losses is
   printed, not held: the losses fall towards 0 on the seeded data, and the
   relative gap of a vanishing loss grows with it.
   The grid's and the oracle's images/s over steps 2-100, the spawn and
   first-step seconds and ``sumTensor``'s milliseconds on LeNet's 838,858
   f32 parameters are printed: two processes time-slicing one card, not a
   scaling figure.  (b) ``runGrid`` of one node on card 0 (so NCCL) runs
   ``gridslice.meshNode``, its process started beside (a)'s and let onto
   the card once (a) has ended: LeNet f32 through ``FusedStep(mesh=...)`` over a
   one-rank ``DeviceMesh`` and through the step over no mesh, 20 steps of
   128 each from the same start: the weights bit-equal, one graph recorded
   for each, K1's launches equal and at least 2 a step, and NCCL's kernel
   (its one-rank reduce) among the kernels of the mesh step's last replay,
   which ``torch.profiler`` traces.  The nodes load the kernels that
   [build] built.
47. [model-parallel], right after [grid]: model parallelism on the one
   card (``tools/mpslice.py``).  (a) ``testlib/pipelinemoe.py``'s trunk at
   its full width (84,224 f32 parameters) on four ranks of
   ``runGrid(..., devices=[0, 0, 0, 0])``, which share card 0 and so run
   over gloo, each with a ``DeviceMesh`` of one "stage" axis: 24 GPipe steps
   of 128 rows in 4 microbatches (``pipelinemoe.train``, 2 epochs of
   ``moeslice.data``'s 1536 seeded rows), each epoch ending in
   ``distributedForward`` of the 256 validation rows.  The parent runs
   ``mpslice.oracle`` meanwhile (the eager pipe microbatch by microbatch, the
   gradients summed), while the ranks import torch, and lets them onto the
   card when it has ended.  Gates: the ranks' final weights bit-equal, the
   weights after step 1 and after step 24 within 1e-5 of max(1, max |w|)
   of the oracle's, the first 10 losses within 1e-4 relative, the last
   ``distributedForward`` within 1e-5 of the eager pipe's forward of each
   64-row microbatch, and K1's launches on each rank 880: 5 products a
   stage forward (the trunk Linear and 4 experts) x (4 microbatches + 3
   recomputed, the last microbatch's forward still held) = 35 a step, x 24,
   + 20 a validation forward x 2; each step's own count 35, and the last
   validation forward's 20, read around it on each rank.  Printed, not
   held: the ranks' and the oracle's rows/s over steps 2-24, the spawn
   seconds and a stage handoff's ms, four processes time-slicing one card.
   (b) On the same ranks: ``SwitchMoE(64, capacityFactor=2.0)``'s
   ``distributedForward`` of the 256 rows over an "expert" axis of 4, one
   expert a rank (one K1 launch each), within 1e-5 of the eager layer, the
   auxiliary loss equal; ``seqParallelMLP`` of x (2048, 512), w1 (512,
   2048), w2 (2048, 512) f32 over a "model" axis of 4 within 1e-4 of the
   dense ``F.gelu(x @ w1, approximate="tanh") @ w2`` (of max |dense|), TF32
   off under ``Config.matmulPrecision = "highest"``.  (c) ``runGrid`` of
   one node on card 0 (so NCCL, a one-rank (data 1, model 1) mesh), its
   process started beside (a)'s and let onto the card once (a) and (b) have
   ended: LeNet f32, 20 steps of 128 through ``FusedStep`` with
   ``tensorParallelSpecs`` (``MomentumSGD``) and with ``zeroOptimizerSpecs``
   (``Adam``), each beside the step over no mesh from the same start: the
   weights bit-equal, one graph recorded for each, K1's launches equal and
   at least 40; the kernels of each sharded step's last replay, which
   ``torch.profiler`` traces, are printed (a one-rank NCCL all-gather may
   leave no kernel).  Then, once every node has ended, K1 at the shapes the
   ranks gave it, (32, 64) x (64, 64) for a stage's trunk on a microbatch
   and (16, 64) x (64, 64) for an expert at the microbatch's capacity,
   against its plain version, as [gemm] holds it.
   The seconds of phases 26 to 47, of [layers]' cases by module and of the
   whole script are printed.

Kernel times are the device's, by CUDA events behind a device sleep that
keeps the host's launch overhead out (``puzzlelib_tpu_torch/tools/timing.py``).
Each kernel's JSON entry carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s and
its operations over 989 TFLOP/s (the H100 SXM's bf16 dense peak; 1979
TOP/s for K1-int8; 67 TFLOP/s for K0, K1's f32 lines and the Winograd
transforms' f32 adds), computed from the shapes of this run.  A Winograd
conv's operations are its 16 products per 2x2 output tile, not the direct
conv's 36.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import itertools
import json
import multiprocessing
import os
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from puzzlelib_tpu_torch.hdf import MemoryStore  # noqa: E402,F401  (the package beside this script)
from puzzlelib_tpu_torch.tools import alexnetslice as Alex  # noqa: E402
from puzzlelib_tpu_torch.tools import c3dslice as C3D  # noqa: E402
from puzzlelib_tpu_torch.tools import cnnslice as Cnn  # noqa: E402
from puzzlelib_tpu_torch.tools import engineslice as Engines  # noqa: E402
from puzzlelib_tpu_torch.tools import resnetslice as Res  # noqa: E402
from puzzlelib_tpu_torch.tools import sequenceslice as Seq  # noqa: E402
from puzzlelib_tpu_torch.tools import transformerslice as Slice  # noqa: E402
from puzzlelib_tpu_torch.tools import zooslice as Zoo  # noqa: E402
from puzzlelib_tpu_torch.tools.timing import (  # noqa: E402
    BF16_FLOP_PER_S, F32_FLOP_PER_S, INT8_OP_PER_S, bound, cardName, deviceMs
)


BATCH = 32
REQUESTS = 4

# (name, x shape NCHW, output channels): each distinct 3x3 conv of VGG-16
# that the Winograd kernel takes, at batch 32, with how often one forward
# pass runs it
WINOGRAD_SHAPES = [
    ("conv2_2", (BATCH, 128, 112, 112), 128, 1),
    ("conv3_1", (BATCH, 128, 56, 56), 256, 1),
    ("conv3_2", (BATCH, 256, 56, 56), 256, 2),
    ("conv4_1", (BATCH, 256, 28, 28), 512, 1),
    ("conv4_2", (BATCH, 512, 28, 28), 512, 2),
    ("conv5_1", (BATCH, 512, 14, 14), 512, 3),
]

# (name, M, K, N): the fc layers at batch 32, and a ragged shape whose K and
# N are no multiples of 8 (the kernel's scalar-load path)
GEMM_SHAPES = [
    ("fc6", BATCH, 25088, 4096),
    ("fc7", BATCH, 4096, 4096),
    ("fc8", BATCH, 4096, 1000),
    ("ragged", 100, 200, 60),
]

# (name, M, K, N, launches per request): the int8 engine's products at batch
# 32, each conv an im2col product (M = 32 OH OW, K = 9 C, N = O).  K is the
# function's own; the engine runs each K padded with zeros to a multiple of
# 16 (conv1_1's 27 as 32), and so does [K1-int8]
INT8_SHAPES = [
    ("conv1_1", BATCH * 224 * 224, 27, 64, 1),
    ("conv1_2", BATCH * 224 * 224, 576, 64, 1),
    ("conv2_1", BATCH * 112 * 112, 576, 128, 1),
    ("conv2_2", BATCH * 112 * 112, 1152, 128, 1),
    ("conv3_1", BATCH * 56 * 56, 1152, 256, 1),
    ("conv3_2", BATCH * 56 * 56, 2304, 256, 2),
    ("conv4_1", BATCH * 28 * 28, 2304, 512, 1),
    ("conv4_2", BATCH * 28 * 28, 4608, 512, 2),
    ("conv5_1", BATCH * 14 * 14, 4608, 512, 3),
    ("fc6", BATCH, 25088, 4096, 1),
    ("fc7", BATCH, 4096, 4096, 1),
    ("fc8", BATCH, 4096, 1000, 1),
]

# ragged M and N, with K off a multiple of 16 (the WMMA kernel) and on one
# (wgmma): no engine product, checked and timed, counted in no request
INT8_RAGGED = [("ragged", 100, 200, 60, 0), ("ragged16", 100, 208, 60, 0)]

# an operations-bound product, no slice's shape: K1's sustained rate beside
# the WMMA kernel and cuBLAS, one of the three sums wgmma is held to
GEMM_SQUARE = ("8192^3", "bf16", 8192, 8192, 8192)

# max |kernel - plain| / max |plain|.  bf16: both round one f32 sum to bf16
# (8 mantissa bits, half an ulp is 2^-9 = 2e-3 of the value) and differ only
# in summation order, so they disagree by at most about one bf16 ulp (4e-3).
# f16: the same with 11 mantissa bits, one ulp 1e-3, inside the same bound.
# f32: only the order of K f32 additions differs, ~sqrt(K) * 6e-8 < 1e-5.
GEMM_BOUND = {"bf16": 1e-2, "f16": 1e-2, "f32": 1e-4}

# Winograd: kernel vs plain share every rounding point (V and U rounded to
# bf16, f32 sums, bf16 output), so they differ by summation order and the
# final rounding.  Against the f32 direct conv the bf16 inputs of the 16
# GEMMs cost about one more mantissa bit than a direct bf16 conv; the
# reference measured ~6e-3 against its f32 oracle.
WINOGRAD_BOUND_PLAIN = 1e-2
WINOGRAD_BOUND_F32 = 2e-2

# relative L2 error of fc8 against the f32 run: the bf16 tier of the
# reference's dtype table (puzzlelib_tpu/tensor.py dtypesSupported)
SLICE_BOUND = 5e-2

# The operations of F(2x2, 3x3) for the bound, besides the 16 products per
# 2x2 output tile per (c, co) (the direct conv's 36, less 2.25x): the f32
# adds of the transforms outside the tensor cores, per tile and channel.
# V = B^T d B of a 4x4 patch, 16 two-term sums per stage: 32 per input
# channel; the forward's A^T M A, 8 then 4 three-term sums: 24 per output
# channel; bwd-filter's Mbar = A dY A^T of a 2x2 tile, the (1 + 2 + 2 + 1)^2
# terms of its 16 entries less 16: 20 per output channel; the filter
# transform U = G g G^T, or dW = G^T dU G, one (16, 9) product per (c, co)
V_ADDS, OUT_ADDS, MBAR_ADDS, FILTER_OPS = 32, 24, 20, 2 * 16 * 9

# K3: kernel and plain share every rounding point (V and Mbar in bf16) and
# differ only in the order of the f32 sums over tiles, ~sqrt(tiles) f32 ulps
# (1e-5 at 100,352 tiles); against the f32 library bwd-filter, the bf16
# transforms cost what K2's cost, hence K2's bound.
FG_BOUND_PLAIN = 1e-3
FG_BOUND_F32 = 2e-2

# K4: (name, (batch, heads, seqQ, d), seqK, causal).  The slice's shape, the
# long sequences of puzzlelib_tpu/benchmarks/attnspeed.py, seqQ != seqK, the
# flash engine's shape ([engine-flash]) and head dim 128 at a long sequence
FLASH_SHAPES = [
    ("slice", (64, 4, 80, 32), 80, False),
    ("slice", (64, 4, 80, 32), 80, True),
    ("long", (4, 8, 2048, 64), 2048, False),
    ("long", (4, 8, 2048, 64), 2048, True),
    ("long", (4, 8, 4096, 64), 4096, False),
    ("long", (4, 8, 4096, 64), 4096, True),
    ("offset", (64, 4, 80, 32), 200, True),
    ("engine", (8, 4, 1024, 64), 1024, False),
    ("long", (4, 8, 2048, 128), 2048, False),
]

# K4's kernels: the wgmma kernel with 64 and 128 query rows a block (the
# wrapper picks one by flash.blockRows), and the first mma.sync kernel, the
# yardstick
FLASH_PATHS = ("wgmma-64", "wgmma-128", "mma")

# K4 vs its plain version, relative to max |plain|.  out: both round P to bf16
# for the product with v and sum in f32; they differ in where P is rounded
# (against the running max in the kernel, the row's max in the plain version),
# in the order of the sums, and by one final bf16 rounding of out (2^-8 of the
# value at most), so about one bf16 ulp: 1e-2.  lse: f32 in both, the same
# scores up to f32 summation order and exp2 against exp, some 1e-6: 1e-4.
FLASH_BOUND_OUT = 1e-2
FLASH_BOUND_LSE = 1e-4

# K5 (the backward) at K4's shapes, the long sequence at head dim 128 among
# them (the instances with the most registers), and seqQ > seqK causal, whose
# first 32 rows see no key (p = 1 for every key, as in the TPU kernels)
FLASH_BWD_SHAPES = FLASH_SHAPES + [("blind", (64, 4, 80, 32), 48, True)]

# K5a / K5b vs backwardPlain, relative to max |plain| of each of dq, dk, dv:
# both round P and dS to bf16 for the products that take them and sum in
# f32; they differ in the order of the sums, in exp2 against exp where a
# rounding of P or dS flips, and by one final bf16 rounding, about one bf16
# ulp: 1e-2
FLASH_BWD_BOUND = 1e-2

# the transformer training slice's first-step gradients compared with the
# library route's backward on one forward (relative L2, the bf16 tier)
TRANSFORMER_GRADS = ("embed.W", "attn0.1.Wq", "attn0.1.Wo", "attn0.0.scale", "head.3.W")

# training: 4 steps of 32
STEPS = 4
LEARN_RATE = 1e-4

# first-step gradients (the backward of one forward pass on both routes) and
# step losses against the bf16 library route: relative L2 and relative
# difference, the bf16 tier as for the serving slice
TRAIN_BOUND = 5e-2
GRAD_LAYERS = ("conv2_2", "conv3_1", "conv4_2", "conv5_3", "fc6", "fc8")

# [resnet50]'s controls, the library route against itself: its backward of
# one forward from the loss gradient one bf16 ulp apart (these seeds), and
# its 12 steps from the input one bf16 ulp apart ((one pixel in every n,
# seed)).  They read how far bf16's rounding alone moves each gradient, and
# the running stats after 12 steps; the hand route is held within
# TRAIN_BOUND or no farther than the farthest control
RESNET_GRAD_SEEDS = (1, 2, 3)
RESNET_INPUT_CONTROLS = ((1, 1), (1, 2), (16, 1), (16, 2))

# [lenet]: LeNet's two products at batch 128, (name, M, K, N); K1 runs
# both forward (f32 on the scalar-load kernel; in bf16 the first on wgmma,
# the second, N off a multiple of 8, on WMMA)
LENET_GEMMS = [("lenet-fc1", Cnn.BATCH, 800, 1024), ("lenet-fc2", Cnn.BATCH, 1024, 10)]

# [lenet], [nin-cifar]: f32 step losses of the hand route against the
# library route's, relative difference (the f32 products differ in
# summation order only)
CNN_LOSS_BOUND = 1e-4

# P3: 64 Mi bf16 values as (131072, 512), the roofline probe's stream
STREAM_SHAPE = (131072, 512)

# P2: (NHWC image, tile rows): the strided-copy probe's own shape, VGG-16's
# largest activation at batch 1, and a ragged one (C-value rows of 48 bytes,
# a batch of 2 of which the copy reads the first, as the TPU kernel does)
PHASE_SHAPES = [((1, 64, 64, 256), 4), ((1, 224, 224, 64), 4), ((2, 16, 16, 24), 2)]

# P1: (name, x shape NCHW, output channels), 3x3 at pad 1: the tap-dot
# probe's three shapes (r50-56 and r50-28 are VGG-16's conv3_x and conv4_x
# at batch 32) and VGG-16's conv2_2 and conv5_2 at batch 32; then two ragged
# checks, not timed
TAPDOT_SHAPES = [
    ("r50-56", (32, 256, 56, 56), 256),
    ("r50-28", (32, 512, 28, 28), 512),
    ("vgg-112", (16, 128, 112, 112), 128),
    ("conv2_2", (BATCH, 128, 112, 112), 128),
    ("conv5_2", (BATCH, 512, 14, 14), 512),
]
TAPDOT_RAGGED = [("ragged", (3, 48, 13, 11), 80, "bf16"), ("ragged-f16", (2, 32, 9, 30), 48, "f16")]

# P1's kernels: the wgmma one tapdot takes, and the first mma.sync one, the
# yardstick, reached through tapdot._launch
TAPDOT_PATHS = ("wgmma", "mma")

# K0 and P3 against their library calls: 200 calls a turn, 5 alternating
# turns, the medians (both sit within a few per cent of their calls, where
# 10 calls could not tell them apart)
LAUNCH_FLOOR_CALLS = 200
LAUNCH_FLOOR_TURNS = 5

# P1 against its plain version, relative L2: both sum exact bf16 products in
# f32 and round once, in another order; against the f32 conv, max |error| /
# max |f32|, the probe's own gate (tools/tapdot_probe.py:244)
TAPDOT_BOUND_PLAIN = 5e-3
TAPDOT_BOUND_F32 = 5e-2

# [engine-flash]: a float-input attention net (LayerNorm, MultiHeadAttention)
# whose "auto" core is flash in bf16 on the card at seq >= 1024; 4 requests
ATTN_NET = dict(batch=8, seq=1024, emb=256, heads=4)

# [w2l]: CTC on the card against hostCTCLoss in f64 at the slice's shape,
# relative error of the summed NLL and max |diff| / max |host| of the
# gradient: the recursions run in f64 (ops/ctc.py), the softmax and its log
# in f32, whose rounding moves the NLL by some 1e-7 of itself
CTC_HOST_BOUND = 1e-4

# [costs]: each cost on the card against the same call on the CPU, in f32
COST_BOUND = 1e-5

# [data]: rows a chunk that LeNet's two routes train on, the Serial's
# threads, the NIN's images and chunk, the LSTM's rows, LeNet's held-out
# error bound (chance is 0.9), and the numpy seeds of the files, of the
# trainers' shuffles and of IMDB's split shuffles
DATA_CHUNK = 10000
DATA_THREADS = 4
DATA_NIN_IMAGES, DATA_NIN_CHUNK = 25000, 2500
DATA_LSTM_ROWS = 256
DATA_LENET_ERROR = 0.10
DATA_SEEDS = {"files": 0, "shuffle": 4, "imdb": 3}

# the routes of the ResNet-50, U-Net and Inception phases (and of [imdb-rnn])
SLICE_ROUTES = {"hopper": "eager hand route", "torch": "library route (cuDNN / cuBLAS)", "fused": "fused route"}


def fail(message):
    raise SystemExit("chip_smoke FAILED: %s" % message)


def relErr(torch, got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def phaseDevice(torch):
    card = cardName()
    print(card)
    print("[device] %s | torch %s, CUDA %s, %d card(s)" %
          (torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    return card


def phaseBuild(build, pool):
    """Every kernel built, one ``nvcc`` a source in parallel, with the engine
    driver's ``g++`` compile started beside them on ``pool``: returns the
    driver's future, (path, seconds), which [engine-driver] waits for."""
    from puzzlelib_tpu_torch.converter.engine.src import build as driverBuild

    def buildDriver():
        begin = time.perf_counter()
        return driverBuild.buildDriver(log=False), time.perf_counter() - begin

    start = time.perf_counter()
    driverJob = pool.submit(buildDriver)
    build.buildAll()
    secs = time.perf_counter() - start

    print("[build] kernels built in %.2f s into %s" % (secs, build.BUILD_DIR))
    for name in build.KERNELS:
        for line in build.compilerReport(name):
            print("[build] %s: %s" % (name, line))

    return driverJob


def _medianTurns(fns, iters=10, turns=2):
    """``deviceMs`` of each of ``fns`` over ``iters`` calls, in ``turns``
    alternating turns (a, b; b, a; ...): each one's median, and each one's
    turns."""
    runs = [[] for _ in fns]
    for turn in range(turns):
        order = range(len(fns)) if turn % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            runs[i].append(deviceMs(fns[i], iters))
    return [float(np.median(r)) for r in runs], runs


def _gemmCase(torch, matmul, gen, label, dtName, m, k, n, plainIters=10):
    """K1 at one shape: the routed kernel against its plain version and its
    second call bit for bit; the device times of the routed kernel and of
    the tiled kernel on the same operands (WMMA for bf16 and f16, reached
    through the wrapper's private path argument) in turns, of wgmma with
    64-row blocks where the route takes 128, of the plain version and of
    cuBLAS.  Returns the case's numbers."""
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[dtName]
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path = matmul._route(m, n, k, dtype, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0, sms)
    wmmaPath = "tiled-vec" if path.startswith("wgmma") else path

    out, ref = matmul.matmul(a, b), matmul.plain(a, b)
    again = matmul.matmul(a, b)
    torch.cuda.synchronize()
    err, repeats = relErr(torch, out, ref), torch.equal(out, again)

    def onPath(route):
        dst = torch.empty_like(out)
        return lambda: matmul._launch(a, b, dst, route)

    if wmmaPath == path:
        ms = wmmaMs = deviceMs(lambda: matmul.matmul(a, b), 10)
    else:
        (ms, wmmaMs), _ = _medianTurns([lambda: matmul.matmul(a, b), onPath(wmmaPath)])
    step1Ms = deviceMs(onPath("wgmma-64"), 10) if path == "wgmma-128" else None
    plainMs = deviceMs(lambda: matmul.plain(a, b), plainIters)
    libMs = deviceMs(lambda: torch.matmul(a, b), 10)
    boundMs, boundBy = bound((m * k + k * n + m * n) * a.element_size(), 2 * m * k * n,
                             F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)

    others = "" if wmmaPath == path else ", WMMA %.4f ms" % wmmaMs
    if step1Ms is not None:
        others += ", wgmma-64 %.4f ms" % step1Ms
    print("[K1] %-8s %s M=%d K=%d N=%d on %s: rel err %.3e (bound %.0e), second call %s; kernel %.4f ms (%.1f "
          "TF/s)%s, plain %.4f ms, library (cuBLAS) %.4f ms, bound %.4f ms (%s)" %
          (label, dtName, m, k, n, path, err, GEMM_BOUND[dtName], "bit-equal" if repeats else "DIFFERENT", ms,
           2 * m * k * n / ms / 1e9, others, plainMs, libMs, boundMs, boundBy))

    if not err <= GEMM_BOUND[dtName]:
        fail("K1 %s %s disagrees with its plain version: %.3e" % (label, dtName, err))

    if not repeats:
        fail("K1 %s %s gives other bits on a second call" % (label, dtName))

    return {"name": label, "dtype": dtName, "path": path, "abs_err": (out.float() - ref.float()).abs().max().item(),
            "ms": ms, "wmma_ms": wmmaMs, "step1_ms": step1Ms, "plain_ms": plainMs, "library_ms": libMs,
            "bound_ms": boundMs, "bound_by": boundBy}


def _addCase(main, binding, case, count=1):
    main["max_abs_err"] = max(main["max_abs_err"], case["abs_err"])
    for key in ("ms", "wmma_ms", "plain_ms", "library_ms", "bound_ms"):
        main[key] += case[key] * count
    binding.add(case["bound_by"])


def _againstWmma(vgg, transformer, square, cases):
    """Whether K1 on wgmma beats the WMMA kernel in this call: faster at fc6
    + fc7 + fc8, at one transformer request and at 8192^3, no more than 5 %
    slower at any single slice shape, and 128-row blocks faster than 64-row
    ones where the route takes them.  Printed, not a gate: a time is no
    correctness check."""
    ratios = [(case["ms"] / case["wmma_ms"], case["name"], case["dtype"]) for case in cases
              if case["path"].startswith("wgmma")]
    worst = max(ratios)
    print("[K1] wgmma against WMMA (bf16, same call): fc6+fc7+fc8 %.4f against %.4f ms; one "
          "transformer request %.4f against %.4f ms (its head stays on WMMA); 8192^3 %.4f ms (%.1f TF/s) against "
          "%.4f ms (%.1f TF/s), 64-row blocks there %.4f ms (%.1f TF/s), cuBLAS %.4f ms (%.1f TF/s); slowest single "
          "slice shape on wgmma against WMMA: %s %s at %.3fx" %
          (vgg["ms"], vgg["wmma_ms"], transformer["ms"], transformer["wmma_ms"], square["ms"],
           _tflops(square, "ms"), square["wmma_ms"], _tflops(square, "wmma_ms"), square["step1_ms"],
           _tflops(square, "step1_ms"), square["library_ms"], _tflops(square, "library_ms"), worst[1], worst[2],
           worst[0]))

    met = (vgg["ms"] < vgg["wmma_ms"] and transformer["ms"] < transformer["wmma_ms"] and
           square["ms"] < square["wmma_ms"] and square["ms"] < square["step1_ms"] and worst[0] <= 1.05)
    print("[K1] wgmma faster than WMMA at the three sums and within 5 %% at every slice shape: %s" %
          ("yes" if met else "NO"))


def _tflops(case, key):
    _, _, m, k, n = GEMM_SQUARE
    return 2 * m * k * n / case[key] / 1e9


def phaseGemm(torch, matmul):
    """K1 at VGG's fc shapes and the ragged one in bf16, f16 and f32, at the
    transformer slice's shapes in bf16 and f16, and at 8192^3 in bf16, with
    its wgmma kernel held against WMMA.  Returns the JSON entries'
    numbers: fc6 + fc7 + fc8 in bf16, and one request of the transformer
    slice."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    vgg, transformer = ({"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": 0.0} for _ in range(2))
    vggBinding, transformerBinding = set(), set()
    sliceCases = []

    for dtName in ("bf16", "f16", "f32"):
        for name, m, k, n in GEMM_SHAPES:
            case = _gemmCase(torch, matmul, gen, name, dtName, m, k, n)
            if dtName == "bf16" and name != "ragged":
                _addCase(vgg, vggBinding, case)
            if dtName != "f32" and name != "ragged":
                sliceCases.append(case)

    for dtName in ("bf16", "f16"):
        for name, m, k, n, count in Slice.GEMMS:
            case = _gemmCase(torch, matmul, gen, name, dtName, m, k, n)
            if dtName == "bf16":
                _addCase(transformer, transformerBinding, case, count)
            sliceCases.append(case)

    square = _gemmCase(torch, matmul, gen, *GEMM_SQUARE, plainIters=2)
    torch.cuda.empty_cache()
    _againstWmma(vgg, transformer, square, sliceCases)

    vgg["bound_by"] = "/".join(sorted(vggBinding))
    transformer["bound_by"] = "/".join(sorted(transformerBinding))
    return vgg, transformer


def _winogradBound(xshape, co, transformOps, weightBytes):
    """(2x2 output tiles, bound ms, what binds) of a 3x3 pad-1 Winograd conv
    of x (N, C, H, W) to ``co`` channels: x and y (N, CO, H, W) read or
    written once in bf16, the filter in ``weightBytes`` per value, the 16
    products per tile per (c, co) and ``transformOps(tiles, c, co)`` f32
    operations."""
    n, c, h, w = xshape
    tiles = n * -(-h // 2) * -(-w // 2)
    boundMs, boundBy = bound((n * c * h * w + n * co * h * w) * 2 + co * c * 9 * weightBytes,
                             2 * 16 * tiles * c * co, f32Flops=transformOps(tiles, c, co))
    return tiles, boundMs, boundBy


def phaseConv(torch, tag, seed, operands, kernel, plain, library, f32, bounds, transformOps, weightBytes=2):
    """One conv kernel against its plain version and against an f32 library
    reference (TF32 off) at each distinct Winograd-eligible VGG-16 conv at
    batch 32.  ``operands(gen, xshape, co)`` makes the bf16 operands of the
    conv of x (N, C, H, W) at pad 1 to ``co`` channels; ``kernel``,
    ``plain``, ``library`` (the library's bf16 call) and ``f32`` take them.
    Each conv reads or writes x and y (N, CO, H, W) in bf16 and the 3x3
    filter in ``weightBytes`` per value, and does the Winograd products,
    2 * 16 per 2x2 output tile per (c, co) on the tensor cores, and
    ``transformOps(tiles, c, co)`` f32 operations outside them.  Returns the
    JSON entry's numbers for one batch of the 10 convs.

    The kernel and the library are also timed on channels-last copies of
    the operands, as the training path hands them over (``ops/conv.py``
    ``kernelLayout``; K2's output stays channels-last), with the share of the
    NCHW-operand time that the wrapper's layout copies take and the rate of
    the 16 products; the kernel must give the same bits on a second call and
    on the channels-last operands."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on although Config.matmulPrecision is 'highest'")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    main = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "channels_last_ms": 0.0, "channels_last_library_ms": 0.0}
    binding = set()
    boundPlain, boundF32 = bounds

    for name, xshape, co, count in WINOGRAD_SHAPES:
        args = operands(gen, xshape, co)

        out, ref, direct = kernel(*args), plain(*args), f32(*args)
        torch.cuda.synchronize()

        errPlain, errF32 = relErr(torch, out, ref), relErr(torch, out, direct)
        absPlain = (out.float() - ref.float()).abs().max().item()
        del out, ref, direct

        ms = deviceMs(lambda: kernel(*args), 10)
        plainMs = deviceMs(lambda: plain(*args), 2)
        libMs = deviceMs(lambda: library(*args), 10)

        tiles, boundMs, boundBy = _winogradBound(xshape, co, transformOps, weightBytes)

        print("[%s] %-7s x=%s co=%d: rel err %.3e vs plain (bound %.0e), %.3e vs f32 library (bound %.0e); "
              "kernel %.4f ms, plain %.4f ms, library bf16 %.4f ms, bound %.4f ms (%s)" %
              (tag, name, xshape, co, errPlain, boundPlain, errF32, boundF32, ms, plainMs, libMs, boundMs, boundBy))

        last = tuple(a.contiguous(memory_format=torch.channels_last) for a in args)
        first, again, onLast = kernel(*args), kernel(*args), kernel(*last)
        torch.cuda.synchronize()
        same = torch.equal(first, again) and torch.equal(first, onLast)
        del first, again, onLast

        lastMs = deviceMs(lambda: kernel(*last), 10)
        libLastMs = deviceMs(lambda: library(*last), 10)
        rate = 2 * 16 * tiles * xshape[1] * co / 1e9
        print("[%s] %-7s channels-last operands: kernel %.4f ms (%.1f TF/s of the 16 products; NCHW %.1f), "
              "the wrapper's layout copies %.1f %% of the NCHW time, library bf16 %.4f ms; two calls and the "
              "channels-last call bit-equal: %s" %
              (tag, name, lastMs, rate / lastMs, rate / ms, 100 * (ms - lastMs) / ms, libLastMs, same))

        if not same:
            fail("%s %s gives other bits on a second call or on channels-last operands" % (tag, name))

        del last

        if not errPlain <= boundPlain:
            fail("%s %s disagrees with its plain version: %.3e" % (tag, name, errPlain))

        if not errF32 <= boundF32:
            fail("%s %s disagrees with the f32 library reference: %.3e" % (tag, name, errF32))

        main["max_abs_err"] = max(main["max_abs_err"], absPlain)
        main["ms"] += ms * count
        main["plain_ms"] += plainMs * count
        main["library_ms"] += libMs * count
        main["bound_ms"] += boundMs * count
        main["channels_last_ms"] += lastMs * count
        main["channels_last_library_ms"] += libLastMs * count
        binding.add(boundBy)

    main["bound_by"] = "/".join(sorted(binding))
    torch.cuda.empty_cache()
    return main


def _winogradSpecs(torch, winograd):
    """K2 forward; K2 as bwd-data (the forward on the rotated, io-swapped
    filter); K3, whose dW is compared before the cast to the weight's type:
    {tag: ``phaseConv``'s arguments after the tag}, each kernel with its
    operands, plain version, library call (bf16) and f32 library
    reference."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    bf16 = torch.bfloat16

    def weights(gen, c, co):
        return (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * c)) ** 0.5).to(bf16)

    def forwardOperands(gen, xshape, co):
        x = torch.randn(xshape, generator=gen, device="cuda").to(bf16)
        return x, weights(gen, xshape[1], co)

    def dataGradOperands(gen, xshape, co):
        n, c, h, w = xshape
        dy = (torch.randn((n, co, h, w), generator=gen, device="cuda") * 0.1).to(bf16)
        return dy, weights(gen, c, co)

    def filterGradOperands(gen, xshape, co):
        n, c, h, w = xshape
        x = torch.randn(xshape, generator=gen, device="cuda").to(bf16)
        return x, (torch.randn((n, co, h, w), generator=gen, device="cuda") * 0.1).to(bf16)

    def xshapeOf(dy, w):
        return (dy.shape[0], w.shape[1]) + tuple(dy.shape[2:])

    def wshapeOf(x, dy):
        return (dy.shape[1], x.shape[1], 3, 3)

    return {
        "K2": dict(
            seed=2, operands=forwardOperands,
            kernel=lambda x, w: winograd.conv2d(x, w, (1, 1)),
            plain=lambda x, w: winograd.plain(x, w, (1, 1)),
            library=lambda x, w: F.conv2d(x, w, padding=1),
            f32=lambda x, w: F.conv2d(x.float(), w.float(), padding=1),
            bounds=(WINOGRAD_BOUND_PLAIN, WINOGRAD_BOUND_F32),
            transformOps=lambda tiles, c, co: (V_ADDS * c + OUT_ADDS * co) * tiles + FILTER_OPS * c * co),
        "K2-bwd": dict(
            seed=3, operands=dataGradOperands,
            kernel=lambda dy, w: winograd.dataGrad(dy, w, (1, 1)),
            plain=lambda dy, w: winograd.plain(dy, w.flip((2, 3)).transpose(0, 1), (1, 1)),
            library=lambda dy, w: conv2d_input(xshapeOf(dy, w), w, dy, padding=1),
            f32=lambda dy, w: conv2d_input(xshapeOf(dy, w), w.float(), dy.float(), padding=1),
            bounds=(WINOGRAD_BOUND_PLAIN, WINOGRAD_BOUND_F32),
            transformOps=lambda tiles, c, co: (V_ADDS * co + OUT_ADDS * c) * tiles + FILTER_OPS * c * co),
        "K3": dict(
            seed=4, operands=filterGradOperands,
            kernel=lambda x, dy: winograd.filterGrad(x, dy, (1, 1)),
            plain=lambda x, dy: winograd.filterGradPlain(x, dy, (1, 1)),
            library=lambda x, dy: conv2d_weight(x, wshapeOf(x, dy), dy, padding=1),
            f32=lambda x, dy: conv2d_weight(x.float(), wshapeOf(x, dy), dy.float(), padding=1),
            bounds=(FG_BOUND_PLAIN, FG_BOUND_F32), weightBytes=4,
            transformOps=lambda tiles, c, co: (V_ADDS * c + MBAR_ADDS * co) * tiles + FILTER_OPS * c * co),
    }


def phaseWinograd(torch, winograd):
    """K2, K2-bwd and K3 at VGG-16's shapes (``phaseConv``)."""
    specs = _winogradSpecs(torch, winograd)
    return tuple(phaseConv(torch, tag, **specs[tag]) for tag in ("K2", "K2-bwd", "K3"))


def phaseSlice(torch, card):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = True   # no gradient buffers for a serving net

    np.random.seed(0)
    net = loadVGG(None, "16", initscheme="he")
    images = np.random.RandomState(1).randn(BATCH * REQUESTS, 3, 224, 224).astype(np.float32)
    first = torch.from_numpy(images[:BATCH]).cuda()

    # the f32 reference: the same weights on the library route (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    net(first)
    refFc8 = net["fc8"].data.float().clone()
    net.reset()
    Config.gemmAlgo = Config.convAlgo = "hopper"

    net.calcMode(torch.bfloat16)

    def serve():
        """One timed ``calcFromHost`` of all the images: (output, seconds)."""
        synchronize()
        start = time.perf_counter()
        result = Calculator(net, batchsize=BATCH).calcFromHost(images)
        synchronize()
        return result, time.perf_counter() - start

    # warm-up of both routes: library conv plans, allocator blocks of these sizes
    for algo in ("torch", "hopper"):
        Config.gemmAlgo = Config.convAlgo = algo
        serve()

    matmul.launches = matmul.launchesWgmma = winograd.launches = 0
    out, secs = serve()
    launches = {"matmul": matmul.launches, "matmulWgmma": matmul.launchesWgmma, "winograd": winograd.launches}

    print("[slice] VGG-16 bf16, %d images in %d requests of %d: %.4f s, %.1f images/s on %s" %
          (len(images), REQUESTS, BATCH, secs, len(images) / secs, card))
    print("[slice] launches in that run: winograd %d, matmul %d (on wgmma %d)" %
          (launches["winograd"], launches["matmul"], launches["matmulWgmma"]))

    if launches != {"matmul": 3 * REQUESTS, "matmulWgmma": 3 * REQUESTS, "winograd": 10 * REQUESTS}:
        fail("expected 40 Winograd and 12 GEMM launches, all 12 on wgmma, got %s" % launches)

    if out.shape != (len(images), 1000) or not np.isfinite(out).all():
        fail("output of shape %s, finite: %s" % (out.shape, np.isfinite(out).all()))

    rowSums = np.abs(out.sum(axis=1) - 1.0).max()
    if not rowSums <= 2e-2:
        fail("softmax rows do not sum to 1 (max deviation %.3e)" % rowSums)

    # steady state, and the same bf16 runs on the library route for the cost
    # of the kernels end to end, in turns
    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            Config.gemmAlgo = Config.convAlgo = algo
            runs[algo].append(serve()[1])
    Config.gemmAlgo = Config.convAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels"), ("torch", "library route (cuBLAS / cuDNN)")):
        print("[slice] %s, 5 runs in turns: %s s, median %.1f images/s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(images) / float(np.median(runs[algo]))))

    net(torch.from_numpy(images[:BATCH]).cuda().to(torch.bfloat16))
    fc8 = net["fc8"].data.float()
    rel = ((fc8 - refFc8).norm() / refFc8.norm()).item()
    net.reset()

    print("[slice] fc8 of the first request vs the f32 library run: relative L2 %.3e (bound %.0e); "
          "softmax rows within %.2e of 1" % (rel, SLICE_BOUND, rowSums))

    if not rel <= SLICE_BOUND:
        fail("fc8 relative L2 error %.3e against the f32 run" % rel)

    return launches, net, images


def _layerGrads(net, names=GRAD_LAYERS):
    """{name: gradient in f32} of the weights of the layers ``names``, or of
    every variable of ``net`` by its table name where ``names`` is None."""
    if names is None:
        return {varNames[0]: var.grad.float().clone() for var, varNames in net.getVarTable().items()}
    return {name: net[name].vars["W"].grad.float().clone() for name in names}


def _stepGrads(trainer, net, images, labels):
    """The gradients of GRAD_LAYERS' weights after one training step on the
    first batch, in f32."""
    np.random.seed(3)
    trainer.trainFromHost(images[:BATCH], labels[:BATCH], macroBatchSize=BATCH)
    return _layerGrads(net)


def _backwardGrads(torch, Config, trainer, net, images, labels, names=GRAD_LAYERS, batch=BATCH, seeds=()):
    """One forward pass of the first batch on the hand kernels, then the
    backward of that same forward on each route, as ``Trainer.handleBatch``
    runs it, and on the library route from the loss gradient one bf16 ulp
    apart (``_ulpApart``) for each of ``seeds``: {route or seed: the
    gradients of ``_layerGrads(net, names)``}."""
    from puzzlelib_tpu_torch.backend import gpuarray

    Config.gemmAlgo = Config.convAlgo = "hopper"
    net.trainMode()
    grad = trainer.cost(net(gpuarray.to_gpu(images[:batch], dtype=torch.bfloat16)),
                        gpuarray.to_gpu(labels[:batch]), queryError=False)

    grads = {}
    runs = [("hopper", grad), ("torch", grad)] + [(seed, _ulpApart(torch, grad, seed)) for seed in seeds]
    for key, lossGrad in runs:
        Config.gemmAlgo = Config.convAlgo = "hopper" if key == "hopper" else "torch"
        trainer.optimizer.zeroGradParams()
        net.backward(lossGrad, updGrad=False)
        grads[key] = _layerGrads(net, names)

    net.reset()
    return grads


def _ulpApart(torch, x, seed, share=1.0):
    """The bf16 tensor ``x`` with a ``share`` of its values, drawn from
    ``seed``, each moved one bf16 ulp up or down in magnitude at random (a
    zero that would go below stays): a disturbance at the size of bf16's
    rounding, for the controls of [resnet50]."""
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    step = torch.randint(0, 2, bits.shape, generator=gen, device=x.device, dtype=torch.int32) * 2 - 1
    step *= torch.rand(bits.shape, generator=gen, device=x.device) < share
    magnitude = ((bits & 0x7FFF) + step).clamp(min=0)
    return ((bits & ~0x7FFF) | magnitude).to(torch.int16).view(torch.bfloat16)


def _relL2(got, ref):
    return ((got - ref).norm() / ref.norm()).item()


def phaseTrain(torch, card):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.handlers import Trainer
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = False   # the serving phase set it: training needs gradient buffers

    def setup(dtype):
        net = loadVGG(None, "16", initscheme="none")
        net.pop()                   # CrossEntropy takes the raw scores
        net.calcMode(dtype)
        opt = MomentumSGD(LEARN_RATE, momRate=0.9)
        opt.setupOn(net, useGlobalState=True)
        return net, opt, Trainer(net, CrossEntropy(), opt, batchsize=BATCH)

    np.random.seed(0)
    heNet = loadVGG(None, "16", initscheme="he")
    table = paramsToNumpy(heNet)
    del heNet

    net, opt, trainer = setup(torch.bfloat16)
    paramsFromNumpy(net, table)
    flat, mom = opt.shParams[torch.bfloat16].ary, opt.states[torch.bfloat16]["mom"]
    start = flat.clone()

    def restore():
        flat.copy_(start)
        mom.zero_()
        opt.t = 0

    images = np.random.RandomState(1).randn(BATCH * STEPS, 3, 224, 224).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 1000, size=BATCH * STEPS).astype(np.int32)

    def train(algo, losses=None):
        """One timed ``trainFromHost`` of all the images from the start
        weights, shuffled by one seed: seconds."""
        Config.gemmAlgo = Config.convAlgo = algo
        restore()
        trainer.onBatchFinish = None if losses is None else (lambda h: losses.append(h.cost.getError()))

        np.random.seed(4)
        synchronize()
        t0 = time.perf_counter()
        trainer.trainFromHost(images, labels, macroBatchSize=BATCH * STEPS)
        synchronize()
        return time.perf_counter() - t0

    # warm-up of both routes: library conv plans, allocator blocks of these sizes
    for algo in ("torch", "hopper"):
        train(algo)

    # the first step's gradients: the backward kernels against the library's
    # on one and the same forward pass (the gate), and whole steps on both
    # bf16 routes and on the f32 library route from the same bf16-rounded
    # weights (printed: a whole bf16 step differs from another by the relu
    # masks and max-pool argmaxes that its rounded forward flips)
    restore()
    backward = _backwardGrads(torch, Config, trainer, net, images, labels)

    grads = {}
    for algo in ("hopper", "torch"):
        Config.gemmAlgo = Config.convAlgo = algo
        restore()
        grads[algo] = _stepGrads(trainer, net, images, labels)

    restore()
    net32, _, trainer32 = setup(torch.float32)
    paramsFromNumpy(net32, paramsToNumpy(net))
    Config.gemmAlgo = Config.convAlgo = "torch"
    grads["f32"] = _stepGrads(trainer32, net32, images, labels)
    del net32, trainer32
    torch.cuda.empty_cache()

    for name in GRAD_LAYERS:
        rel = _relL2(backward["hopper"][name], backward["torch"][name])
        print("[train] first-step dW of %-7s: backward on the hand kernels vs the library's, same forward: relative "
              "L2 %.3e (bound %.0e); whole bf16 steps, hand kernels vs library %.3e; vs the f32 library step: hand "
              "kernels %.3e, bf16 library %.3e" %
              (name, rel, TRAIN_BOUND, _relL2(grads["hopper"][name], grads["torch"][name]),
               _relL2(grads["hopper"][name], grads["f32"][name]), _relL2(grads["torch"][name], grads["f32"][name])))

        if not rel <= TRAIN_BOUND:
            fail("first-step gradient of %s on the hand kernels differs from the library's by %.3e" % (name, rel))

    # the counted run
    variables = list(net.getVarTable())
    snapshot = [var.data.clone() for var in variables]

    losses = []
    matmul.launches = matmul.launchesWgmma = 0
    winograd.launches = winograd.dataGradLaunches = winograd.filterGradLaunches = 0
    secs = train("hopper", losses)
    launches = {"matmul": matmul.launches, "matmulWgmma": matmul.launchesWgmma, "winograd": winograd.launches,
                "winogradDataGrad": winograd.dataGradLaunches, "winogradFG": winograd.filterGradLaunches}

    print("[train] VGG-16 bf16, %d images in %d steps of %d: %.4f s, %.1f images/s on %s" %
          (len(images), STEPS, BATCH, secs, len(images) / secs, card))
    print("[train] launches in that run: winograd %d (forward %d, bwd-data %d), winogradFG %d, matmul %d (on wgmma "
          "%d)" % (launches["winograd"], launches["winograd"] - launches["winogradDataGrad"],
                   launches["winogradDataGrad"], launches["winogradFG"], launches["matmul"], launches["matmulWgmma"]))

    expected = {"matmul": 3 * STEPS, "matmulWgmma": 3 * STEPS, "winograd": 20 * STEPS,
                "winogradDataGrad": 10 * STEPS, "winogradFG": 10 * STEPS}
    if launches != expected:
        fail("expected launches %s, got %s" % (expected, launches))

    print("[train] step losses: %s" % " ".join("%.6f" % loss for loss in losses))
    if len(losses) != STEPS or not np.isfinite(losses).all():
        fail("step losses %s" % losses)

    flatPtr = flat.untyped_storage().data_ptr()
    gradPtr = opt.shGrads[torch.bfloat16].ary.untyped_storage().data_ptr()
    for var, old in zip(variables, snapshot):
        if var.data.untyped_storage().data_ptr() != flatPtr or var.grad.untyped_storage().data_ptr() != gradPtr:
            fail("variable %s is no view of the optimizer's flat buffers" % var.name)

        if torch.equal(var.data, old):
            fail("variable %s did not change in training" % var.name)

    print("[train] all %d variables are views of the flat buffers and changed" % len(variables))
    del snapshot

    # the same run on the bf16 library route
    libLosses = []
    train("torch", libLosses)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, libLosses))
    print("[train] library route step losses: %s; largest relative difference %.3e (bound %.0e)" %
          (" ".join("%.6f" % loss for loss in libLosses), rel, TRAIN_BOUND))

    if not rel <= TRAIN_BOUND:
        fail("step losses differ from the library route's by %.3e" % rel)

    # steady state of both routes, in turns
    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo].append(train(algo))
    Config.gemmAlgo = Config.convAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels"), ("torch", "library route (cuBLAS / cuDNN)")):
        print("[train] %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(images) / float(np.median(runs[algo])), card))

    return launches


def _cnnWarmUp(run, images, labels, valImages, valLabels):
    """Both routes trained and validated once (library conv plans,
    allocator blocks of these sizes)."""
    for algo in ("torch", "hopper"):
        run.train(algo, images, labels)
        run.validate(algo, valImages, valLabels)


def _cnnTurns(tag, run, images, labels, valImages, valLabels, card):
    """5 runs of training then validation on each route, in turns: the
    seconds and median images/s of each, printed."""
    runs = {algo: {"train": [], "validate": []} for algo in ("hopper", "torch")}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo]["train"].append(run.train(algo, images, labels))
            runs[algo]["validate"].append(run.validate(algo, valImages, valLabels)[1])

    for algo, label in (("hopper", "hand route"), ("torch", "library route (cuBLAS / cuDNN)")):
        for what, count in (("train", len(images)), ("validate", len(valImages))):
            secs = runs[algo][what]
            print("[%s] %s, %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
                  (tag, label, what, " ".join("%.4f" % t for t in secs), count / float(np.median(secs)), card))


def _lossesAgainst(tag, losses, refLosses, boundRel, ref="library route"):
    print("[%s] step losses: %s" % (tag, " ".join("%.6f" % loss for loss in losses)))
    if len(losses) != len(refLosses) or not np.isfinite(losses).all():
        fail("%s step losses %s against %s" % (tag, losses, refLosses))

    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, refLosses))
    print("[%s] %s step losses: %s; largest relative difference %.3e (bound %.0e)" %
          (tag, ref, " ".join("%.6f" % loss for loss in refLosses), rel, boundRel))

    if not rel <= boundRel:
        fail("%s step losses differ from the %s's by %.3e" % (tag, ref, rel))


def phaseLeNet(torch, card):
    """LeNet in f32 as ``bench.py`` trains it (``tools/cnnslice.py``): 8
    steps of 128 through ``trainFromHost``, then ``validateFromHost`` over
    1024 images, on the hand route and the library route, K1's launches
    counted in each counted run and in one bf16 run.  K1 is first held to
    its plain version at LeNet's two products.  Returns the launches and
    the JSON entry's numbers (the two f32 products at batch 128)."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul

    Config.device = "cuda"
    images, labels = Cnn.data("lenet", Cnn.BATCH * Cnn.STEPS)
    valImages, valLabels = Cnn.data("lenet", Cnn.VALIDATION, seed=2)

    gen = torch.Generator(device="cuda").manual_seed(5)
    main = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    for dtName in ("f32", "bf16"):
        for name, m, k, n in LENET_GEMMS:
            case = _gemmCase(torch, matmul, gen, name, dtName, m, k, n)
            if dtName == "f32":
                _addCase(main, binding, case)
    main["bound_by"] = "/".join(sorted(binding))
    del main["wmma_ms"]

    run = Cnn.buildRun("lenet")
    _cnnWarmUp(run, images, labels, valImages, valLabels)

    losses = []
    matmul.launches = matmul.launchesWgmma = 0
    secs = run.train("hopper", images, labels, losses)
    launches = {"train": matmul.launches, "trainWgmma": matmul.launchesWgmma}

    matmul.launches = matmul.launchesWgmma = 0
    error, valSecs = run.validate("hopper", valImages, valLabels)
    launches.update(validate=matmul.launches, validateWgmma=matmul.launchesWgmma)

    print("[lenet] LeNet f32, MomentumSGD(%g, %g) in global state: %d images in %d steps of %d, %.4f s, %.1f "
          "images/s; validation of %d images, %.4f s, %.1f images/s on %s" %
          (Cnn.LEARN_RATE, Cnn.MOM_RATE, len(images), Cnn.STEPS, Cnn.BATCH, secs, len(images) / secs,
           len(valImages), valSecs, len(valImages) / valSecs, card))
    print("[lenet] K1 launches (gemmF32): training %d, validation %d (on wgmma %d, %d)" %
          (launches["train"], launches["validate"], launches["trainWgmma"], launches["validateWgmma"]))

    expected = {"train": 2 * Cnn.STEPS, "trainWgmma": 0, "validate": 2 * Cnn.VALIDATION // Cnn.BATCH,
                "validateWgmma": 0}
    if launches != expected:
        fail("[lenet] expected K1 launches %s, got %s" % (expected, launches))

    libLosses = []
    run.train("torch", images, labels, libLosses)
    libError, _ = run.validate("torch", valImages, valLabels)
    _lossesAgainst("lenet", losses, libLosses, CNN_LOSS_BOUND)

    print("[lenet] validation error: hand route %r, library route %r" % (error, libError))
    if error != libError:
        fail("[lenet] validation errors differ between the routes: %r against %r" % (error, libError))

    _cnnTurns("lenet", run, images, labels, valImages, valLabels, card)
    del run

    # one bf16 run: the 800 -> 1024 product on wgmma, the 1024 -> 10 one
    # (N off a multiple of 8) on the WMMA kernel
    run16 = Cnn.buildRun("lenet", dtype=torch.bfloat16)
    run16.train("hopper", images, labels)
    losses16 = []
    matmul.launches = matmul.launchesWgmma = 0
    run16.train("hopper", images, labels, losses16)
    launches.update(bf16=matmul.launches, bf16Wgmma=matmul.launchesWgmma)

    print("[lenet] LeNet bf16 on the hand route: step losses %s; K1 launches %d, on wgmma %d, on WMMA %d" %
          (" ".join("%.6f" % loss for loss in losses16), launches["bf16"], launches["bf16Wgmma"],
           launches["bf16"] - launches["bf16Wgmma"]))

    if (launches["bf16"], launches["bf16Wgmma"]) != (2 * Cnn.STEPS, Cnn.STEPS) or not np.isfinite(losses16).all():
        fail("[lenet] bf16: expected %d K1 launches, %d on wgmma, and finite losses; got %s, %s" %
             (2 * Cnn.STEPS, Cnn.STEPS, launches, losses16))

    return launches, main


def phaseNiNCifar(torch, card):
    """The CIFAR-10 NIN of ``testlib/cnncifar10nin.py`` in f32 with
    ``WeightDecay(1e-4)`` (``tools/cnnslice.py``): 8 steps of 128, then 1024
    validated, on both routes.  It reaches no hand kernel: its 192-channel
    convs go to cuDNN on both routes.  The dropout draws start from one seed
    in every run; in eval mode dropout is the identity, so two validations
    give the same bits."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    images, labels = Cnn.data("nin-cifar", Cnn.BATCH * Cnn.STEPS)
    valImages, valLabels = Cnn.data("nin-cifar", Cnn.VALIDATION, seed=2)

    run = Cnn.buildRun("nin-cifar")
    _cnnWarmUp(run, images, labels, valImages, valLabels)

    losses = []
    matmul.launches = winograd.launches = winograd.filterGradLaunches = 0
    secs = run.train("hopper", images, labels, losses)
    error, valSecs = run.validate("hopper", valImages, valLabels)
    again, _ = run.validate("hopper", valImages, valLabels)
    launches = {"matmul": matmul.launches, "winograd": winograd.launches, "winogradFG": winograd.filterGradLaunches}

    print("[nin-cifar] CIFAR-10 NIN f32, MomentumSGD(%g, %g) with WeightDecay(%g) in global state: %d images in %d "
          "steps of %d, %.4f s, %.1f images/s; validation of %d images, %.4f s, %.1f images/s on %s" %
          (Cnn.LEARN_RATE, Cnn.MOM_RATE, Cnn.WEIGHT_DECAY, len(images), Cnn.STEPS, Cnn.BATCH, secs,
           len(images) / secs, len(valImages), valSecs, len(valImages) / valSecs, card))
    print("[nin-cifar] launches in that run: K1 %d, K2 %d, K3 %d (its 192-channel convs go to cuDNN)" %
          (launches["matmul"], launches["winograd"], launches["winogradFG"]))

    if any(launches.values()):
        fail("[nin-cifar] expected no hand-kernel launch, got %s" % launches)

    libLosses = []
    run.train("torch", images, labels, libLosses)
    libError, _ = run.validate("torch", valImages, valLabels)
    _lossesAgainst("nin-cifar", losses, libLosses, CNN_LOSS_BOUND)

    print("[nin-cifar] validation error: %r, a second validation %r (dropout is the identity in eval mode); "
          "library route %r" % (error, again, libError))
    if not error == again == libError:
        fail("[nin-cifar] validation errors differ: %r, %r, library %r" % (error, again, libError))

    _cnnTurns("nin-cifar", run, images, labels, valImages, valLabels, card)
    return launches


class _LayerLaunches:
    """K2 forward, K2 bwd-data and K3 launches counted inside each named
    conv's own calls (its ``updateData``, ``updateGrad`` and
    ``accGradParams``, wrapped on the instance); ``kernels`` is the
    kernels' wrapper module.  ``replayed()`` names the counts as (holder,
    attribute) pairs, for ``fused.COUNTERS``: a fused step's replays then
    add to them what its recording counted (inside ``with``, they sit
    there)."""

    FIELDS = ("forward", "dataGrad", "filterGrad")
    METHODS = ("updateData", "updateGrad", "accGradParams")

    def __init__(self, kernels, net, names):
        self.kernels = kernels
        self.counts = {name: types.SimpleNamespace(**dict.fromkeys(self.FIELDS, 0)) for name in names}
        paths = dict(net.named_modules())

        for name in names:
            # a layer's path in the tree ("trunk.stage0.moe0.expert1") where
            # names repeat, else its name
            mod = paths[name] if name in paths else next(m for m in net.modules() if m.name == name)
            for method in self.METHODS:
                setattr(mod, method, self._wrap(self.counts[name], getattr(mod, method)))

    def _now(self):
        w = self.kernels
        return w.launches - w.dataGradLaunches, w.dataGradLaunches, w.filterGradLaunches

    def __enter__(self):
        from puzzlelib_tpu_torch import fused as Fused

        Fused.COUNTERS.extend(self.replayed())
        return self

    def __exit__(self, *exc):
        from puzzlelib_tpu_torch import fused as Fused

        for entry in self.replayed():
            Fused.COUNTERS.remove(entry)

    def _wrap(self, counts, fn):
        def call(*args, **kwargs):
            before = self._now()
            result = fn(*args, **kwargs)
            for field, b, a in zip(self.FIELDS, before, self._now()):
                setattr(counts, field, getattr(counts, field) + a - b)
            return result

        return call

    def replayed(self):
        return [(counts, field) for counts in self.counts.values() for field in self.FIELDS]

    def reset(self):
        for counts, field in self.replayed():
            setattr(counts, field, 0)

    def _tuple(self, name):
        return tuple(getattr(self.counts[name], field) for field in self.FIELDS)

    def check(self, tag, want):
        """Fail unless each conv shows ``want`` (forward, bwd-data, bwd-filter)."""
        print("[%s] launches by layer (K2 forward, K2 bwd-data, K3): %s" %
              (tag, ", ".join("%s %s" % (name, self._tuple(name)) for name in self.counts)))

        for name in self.counts:
            if self._tuple(name) != want:
                fail("[%s] %s: expected launches %s, got %s" % (tag, name, want, self._tuple(name)))


def _convKernels(torch, winograd, phase, convs, batch, tags=("K2", "K2-bwd", "K3"), perShape=False):
    """The kernels ``tags`` (of K2, K2-bwd and K3) at ``convs`` ((names, x
    shape at batch 1, output maps)) at ``batch``, for each of a shape's
    space-separated names on operands of its own (with ``perShape``, for
    the first name of each shape, its numbers counted once for each name):
    each against its plain version, then kernel and cuDNN on channels-last
    operands (as the training path hands them over) in 5 alternating turns
    of 10 calls.  Returns the JSON entries' numbers, summed over the convs;
    ``bound_by`` names the bound of the convs whose bounds make up most of
    the sum."""
    specs = _winogradSpecs(torch, winograd)
    entries = {}

    for tag in tags:
        spec = specs[tag]
        gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
        entry = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        binding = {}

        if perShape:
            timed = [(names.split()[0], len(names.split()), inshape, co) for names, inshape, co in convs]
        else:
            timed = [(name, 1, inshape, co) for names, inshape, co in convs for name in names.split()]

        for name, count, inshape, co in timed:
            xshape = (batch, ) + inshape
            args = spec["operands"](gen, xshape, co)
            out, ref = spec["kernel"](*args), spec["plain"](*args)
            torch.cuda.synchronize()
            err, absErr = relErr(torch, out, ref), (out.float() - ref.float()).abs().max().item()
            del out, ref

            last = tuple(a.contiguous(memory_format=torch.channels_last) for a in args)
            (ms, libMs), turns = _medianTurns([lambda: spec["kernel"](*last), lambda: spec["library"](*last)],
                                              turns=5)
            plainMs = deviceMs(lambda: spec["plain"](*args), 2)
            _, boundMs, boundBy = _winogradBound(xshape, co, spec["transformOps"], spec.get("weightBytes", 2))

            print("[%s] %-6s %-10s x=%s co=%d%s: rel err %.3e vs plain (bound %.0e); channels-last operands, "
                  "medians of 5 alternating turns: kernel %.4f ms (turns %s), cuDNN %.4f ms (turns %s), %.2fx "
                  "cuDNN; plain %.4f ms, bound %.4f ms (%s)" %
                  (phase, tag, name, xshape, co, " (x %d convs)" % count if perShape else "", err, spec["bounds"][0],
                   ms, " ".join("%.4f" % t for t in turns[0]), libMs, " ".join("%.4f" % t for t in turns[1]),
                   ms / libMs, plainMs, boundMs, boundBy))

            if not err <= spec["bounds"][0]:
                fail("[%s] %s %s disagrees with its plain version: %.3e" % (phase, tag, name, err))

            entry["max_abs_err"] = max(entry["max_abs_err"], absErr)
            entry["ms"] += count * ms
            entry["plain_ms"] += count * plainMs
            entry["library_ms"] += count * libMs
            entry["bound_ms"] += count * boundMs
            binding[boundBy] = binding.get(boundBy, 0.0) + count * boundMs
            del args, last

        # the sum's bound is that of the shapes that make up most of it
        entry["bound_by"] = max(binding, key=binding.get)
        entries[tag] = entry

    torch.cuda.empty_cache()
    return entries


def phaseNiN(torch, card):
    """The ImageNet NiN in bf16 at batch 128 (``tools/cnnslice.py``): 4
    requests served through ``Calculator`` (logits of the first against
    the same f32 weights on the library route), then, without its SoftMax,
    4 steps trained with ``CrossEntropy`` and ``MomentumSGD`` in global
    state (the first step's dW of conv3 and conv4-1024 on the hand kernels
    against the library's backward on the same forward; the losses against
    the library route's).  Each of conv3 and conv4-1024 must show one K2
    forward a request, and one K2 forward, one K2 bwd-data and one K3 a
    step.  Then K2, K2-bwd and K3 at those two convs' shapes
    (``_convKernels``).  Returns the launches and the kernels' numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = False   # the net is trained after it serves
    convs = [name for name, _, _ in Cnn.NIN_KERNEL_CONVS]

    net = Cnn.build("nin")
    images, labels = Cnn.data("nin", Cnn.BATCH * REQUESTS)
    first = torch.from_numpy(images[:Cnn.BATCH]).cuda()

    # the f32 reference: the same weights on the library route (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    net(first)
    refLogits = net.graph[-2].data.float().clone()
    net.reset()

    net.calcMode(torch.bfloat16)
    counter = _LayerLaunches(winograd, net, convs)

    def serve(algo):
        Config.gemmAlgo = Config.convAlgo = algo
        synchronize()
        start = time.perf_counter()
        result = Calculator(net, batchsize=Cnn.BATCH).calcFromHost(images)
        synchronize()
        return result, time.perf_counter() - start

    for algo in ("torch", "hopper"):
        serve(algo)

    counter.reset()
    matmul.launches = winograd.launches = winograd.dataGradLaunches = winograd.filterGradLaunches = 0
    out, secs = serve("hopper")
    serving = {"winograd": winograd.launches, "matmul": matmul.launches}

    print("[nin] ImageNet NiN bf16, %d images in %d requests of %d: %.4f s, %.1f images/s on %s" %
          (len(images), REQUESTS, Cnn.BATCH, secs, len(images) / secs, card))
    print("[nin] serving launches: winograd %d, matmul %d" % (serving["winograd"], serving["matmul"]))
    counter.check("nin", (REQUESTS, 0, 0))

    if serving != {"winograd": 2 * REQUESTS, "matmul": 0}:
        fail("[nin] expected %d Winograd launches and no GEMM in serving, got %s" % (2 * REQUESTS, serving))

    if out.shape != (len(images), 1000) or not np.isfinite(out).all():
        fail("[nin] output of shape %s, finite: %s" % (out.shape, np.isfinite(out).all()))

    Config.gemmAlgo = Config.convAlgo = "hopper"
    net(first.to(torch.bfloat16))
    rel = _relL2(net.graph[-2].data.float(), refLogits)
    net.reset()
    print("[nin] logits of the first request vs the f32 library run: relative L2 %.3e (bound %.0e)" %
          (rel, SLICE_BOUND))
    if not rel <= SLICE_BOUND:
        fail("[nin] logits relative L2 error %.3e against the f32 run" % rel)

    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo].append(serve(algo)[1])

    for algo, label in (("hopper", "hand kernels"), ("torch", "library route (cuDNN)")):
        print("[nin] serving, %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(images) / float(np.median(runs[algo])), card))

    # training, without the SoftMax
    run = Cnn.buildRun("nin", net=net)
    run.restore()
    backward = _backwardGrads(torch, Config, run.trainer, net, images, labels, names=convs, batch=Cnn.BATCH)
    for name in convs:
        rel = _relL2(backward["hopper"][name], backward["torch"][name])
        print("[nin] first-step dW of %s: backward on the hand kernels vs the library's, same forward: relative "
              "L2 %.3e (bound %.0e)" % (name, rel, TRAIN_BOUND))
        if not rel <= TRAIN_BOUND:
            fail("[nin] first-step gradient of %s differs from the library's by %.3e" % (name, rel))

    for algo in ("torch", "hopper"):
        run.train(algo, images, labels)

    losses = []
    counter.reset()
    matmul.launches = winograd.launches = winograd.dataGradLaunches = winograd.filterGradLaunches = 0
    secs = run.train("hopper", images, labels, losses)
    training = {"winograd": winograd.launches, "winogradDataGrad": winograd.dataGradLaunches,
                "winogradFG": winograd.filterGradLaunches, "matmul": matmul.launches}

    print("[nin] ImageNet NiN bf16 training, MomentumSGD(%g, %g): %d images in %d steps of %d, %.4f s, %.1f "
          "images/s on %s" % (Cnn.NIN_LEARN_RATE, Cnn.MOM_RATE, len(images), REQUESTS, Cnn.BATCH, secs,
                              len(images) / secs, card))
    print("[nin] training launches: winograd %d (forward %d, bwd-data %d), winogradFG %d, matmul %d" %
          (training["winograd"], training["winograd"] - training["winogradDataGrad"], training["winogradDataGrad"],
           training["winogradFG"], training["matmul"]))
    counter.check("nin", (REQUESTS, REQUESTS, REQUESTS))

    expected = {"winograd": 4 * REQUESTS, "winogradDataGrad": 2 * REQUESTS, "winogradFG": 2 * REQUESTS, "matmul": 0}
    if training != expected:
        fail("[nin] expected training launches %s, got %s" % (expected, training))

    libLosses = []
    run.train("torch", images, labels, libLosses)
    _lossesAgainst("nin", losses, libLosses, TRAIN_BOUND)

    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo].append(run.train(algo, images, labels))
    Config.gemmAlgo = Config.convAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels"), ("torch", "library route (cuDNN)")):
        print("[nin] training, %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(images) / float(np.median(runs[algo])), card))

    del run, net
    torch.cuda.empty_cache()
    return serving, training, _convKernels(torch, winograd, "nin", Cnn.NIN_KERNEL_CONVS, Cnn.BATCH)


def phaseCheckinstall(torch, matmul, probe):
    """``checkinstall.main()`` on the card, with the counters reset just
    before and read just after: K0 once and exact, K1 (f32) once within its
    bound.  Returns K0's JSON entry's numbers and the launches."""
    from puzzlelib_tpu_torch import checkinstall, config as Config

    Config.device = "cuda"
    matmul.launches = probe.launches = 0
    result = checkinstall.main()
    launches = {"probe": probe.launches, "matmul": matmul.launches}

    print("[checkinstall] launches in that run: K0 %d, K1 (f32) %d; GEMM probe relative error %.3e (bound %.0e); "
          "K0 max |kernel - plain| %.1e" % (launches["probe"], launches["matmul"], result["gemm_rel_err"],
                                            GEMM_BOUND["f32"], result["probe_abs_err"]))

    if launches != {"probe": 1, "matmul": 1}:
        fail("expected one K0 and one K1 launch in checkinstall, got %s" % launches)

    if not result["gemm_rel_err"] <= GEMM_BOUND["f32"]:
        fail("the GEMM probe disagrees with numpy: %.3e" % result["gemm_rel_err"])

    if result["probe_abs_err"] != 0.0:
        fail("K0 differs from x * 2 by %.3e" % result["probe_abs_err"])

    x = torch.randn((8, 128), device="cuda")
    (ms, libMs), (runs, libRuns) = _medianTurns([lambda: probe.double(x), lambda: torch.mul(x, 2.0)],
                                                 LAUNCH_FLOOR_CALLS, LAUNCH_FLOOR_TURNS)
    plainMs = deviceMs(lambda: probe.plain(x), 10)
    boundMs, boundBy = bound(2 * x.numel() * 4, x.numel(), F32_FLOP_PER_S)

    print("[checkinstall] K0 on (8, 128) f32, medians of %d alternating turns of %d calls: kernel %.5f ms (turns "
          "%s), library (torch.mul) %.5f ms (turns %s), kernel / library %.3f; plain %.4f ms; bound %.6f ms (%s)" %
          (LAUNCH_FLOOR_TURNS, LAUNCH_FLOOR_CALLS, ms, ", ".join("%.5f" % t for t in runs), libMs,
           ", ".join("%.5f" % t for t in libRuns), ms / libMs, plainMs, boundMs, boundBy))

    entry = {"max_abs_err": result["probe_abs_err"], "ms": ms, "plain_ms": plainMs, "bound_ms": boundMs,
             "bound_by": boundBy, "library_ms": libMs}
    return entry, launches


def _libraryInt8(torch, a, b):
    """``torch._int_mm`` (cuBLASLt's int8 product) on a and b, with K padded
    with zeros to a multiple of 8 where its shape rules ask for one (the
    product is the same); None where M <= 16 or N is no multiple of 8."""
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or n % 8 != 0:
        return None

    if k % 8 != 0:
        pad = 8 - k % 8
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))

    return lambda: torch._int_mm(a, b)


def phaseGemmInt8(torch, matmul):
    """K1-int8 at each distinct int8 product of the VGG-16 engine at batch 32
    and the ragged shapes: ``matmulNT`` on a pre-laid-out B^T, on the kernel
    its shape routes to, against its plain version exactly and its second
    call bit for bit; timed in turns beside the WMMA kernel on the same
    operands (B as the (K, N) matrix it reads) and ``torch._int_mm``, with
    the per-call transpose that ``matmul(a, b)`` adds timed apart.  Prints
    the request's 16 products on both kernels and the landing rule's verdict.
    Returns the JSON entry's numbers for one request (the engine's 16
    products)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main = {"max_abs_err": 0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding, ratios = set(), []

    shapes = [(shape, True) for shape in INT8_SHAPES] + [(shape, False) for shape in INT8_RAGGED]
    for (name, m, k, n, count), engine in shapes:
        # an engine product's K padded with zeros, as the engine lays it out
        kt = -(-k // 16) * 16 if engine else k
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        a, bt = (torch.nn.functional.pad(x, (0, kt - k)).contiguous() for x in (a, bt))
        b = bt.t().contiguous()
        path = matmul._route(m, n, kt, torch.int8, a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0, sms)

        out, ref = matmul.matmulNT(a, bt), matmul.plain(a, b)
        again = matmul.matmulNT(a, bt)
        torch.cuda.synchronize()

        exact = out.dtype == torch.int32 and torch.equal(out, ref)
        repeats = torch.equal(out, again)
        absErr = (out.long() - ref.long()).abs().max().item()
        del out, again

        # the WMMA kernel on the same operands, on the path the route gave
        # int8 before wgmma: 16-byte loads where K and N allow
        wmmaPath = "tiled-vec" if kt % 16 == 0 and n % 16 == 0 else "tiled"
        wmmaOut = torch.empty((m, n), dtype=torch.int32, device="cuda")
        fns = [lambda: matmul.matmulNT(a, bt)]
        if path.startswith("wgmma"):
            fns.append(lambda: matmul._launch(a, b, wmmaOut, wmmaPath))
        library = _libraryInt8(torch, a, b)
        if library is not None:
            fns.append(library)

        times, _ = _medianTurns(fns)
        ms = times[0]
        wmmaMs = times[1] if path.startswith("wgmma") else ms
        libMs = times[-1] if library is not None else None
        transposeMs = deviceMs(lambda: b.t().contiguous(), 10) if path.startswith("wgmma") else None
        plainMs = deviceMs(lambda: matmul.plain(a, b), 2)
        wmmaExact = not path.startswith("wgmma") or torch.equal(wmmaOut, ref)
        del ref

        # the bound at the function's own K; at the padded K beside it
        boundMs, boundBy = bound(m * k + k * n + m * n * 4, 2 * m * k * n, INT8_OP_PER_S)
        paddedBound = "" if kt == k else ", %.4f ms at the padded K = %d" % (
            bound(m * kt + kt * n + m * n * 4, 2 * m * kt * n, INT8_OP_PER_S)[0], kt)

        print("[K1-int8] %-8s M=%d K=%d N=%d on %s: %s (max |kernel - plain| %d), second call %s; kernel %.4f ms "
              "(%.1f TOP/s)%s, WMMA (%s) %.4f ms, %s, plain (f64) %.4f ms, library (torch._int_mm) %s ms, bound "
              "%.4f ms (%s%s)%s" %
              (name, m, k, n, path, "exact" if exact else "NOT EXACT", absErr, "bit-equal" if repeats else "DIFFERENT",
               ms, 2 * m * k * n / ms / 1e9,
               "" if transposeMs is None else ", matmul(a, b)'s per-call transpose of b %.4f ms more" % transposeMs,
               wmmaPath, wmmaMs, "exact" if wmmaExact else "NOT EXACT", plainMs,
               "n/a" if libMs is None else "%.4f" % libMs, boundMs, boundBy, paddedBound,
               "" if path.startswith("wgmma") else " (K off a multiple of 16: the WMMA kernel is the kernel)"))

        if not exact:
            fail("K1-int8 %s differs from its plain version by up to %d" % (name, absErr))

        if not repeats:
            fail("K1-int8 %s gives other bits on a second call" % name)

        if not wmmaExact:
            fail("the WMMA kernel (%s) at %s differs from the plain version" % (wmmaPath, name))

        if count:
            main["ms"] += ms * count
            main["wmma_ms"] += wmmaMs * count
            main["plain_ms"] += plainMs * count
            main["library_ms"] += libMs * count
            main["bound_ms"] += boundMs * count
            binding.add(boundBy)
            if path.startswith("wgmma"):
                ratios.append((ms / wmmaMs, name))

        del a, b, bt, wmmaOut
        torch.cuda.empty_cache()

    worst = max(ratios)
    met = main["ms"] <= main["wmma_ms"] / 2 and worst[0] <= 1.05
    print("[K1-int8] a request's 16 products (%d of the 12 shapes on wgmma): kernel %.4f ms against WMMA's %.4f ms in "
          "this call (%.2fx), torch._int_mm %.4f, bound %.4f; slowest shape on wgmma against WMMA: %s at %.3fx" %
          (len(ratios), main["ms"], main["wmma_ms"], main["wmma_ms"] / main["ms"], main["library_ms"],
           main["bound_ms"], worst[1], worst[0]))
    print("[K1-int8] landing rule (a request >= 2x faster than WMMA, no shape on wgmma more than 5 %% slower): %s" %
          ("met" if met else "NOT MET"))

    main["bound_by"] = "/".join(sorted(binding))
    return main


def _engineSizes(net, path):
    """(engine file bytes, bytes of the int8 weights, their f32 scales and
    the f32 biases)."""
    weights = sum(var.data.numel() for var, names in net.getVarTable().items() if names[0].endswith(".W"))
    outputs = sum(var.data.numel() for var, names in net.getVarTable().items() if names[0].endswith(".b"))
    return os.path.getsize(path), weights + 2 * 4 * outputs


def phaseEngineInt8(torch, card, workdir):
    """The int8 engine slice of ``tools/engineslice.py``: VGG-16 at full width
    calibrated, built on the card, loaded back and served; the counters are
    reset just before and read just after the counted run.  Returns the f32
    net, the served images and the launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.converter.engine import Engine
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = True   # no gradient buffers for a serving net
    Config.gemmAlgo = Config.convAlgo = "hopper"

    net = Engines.buildNet()
    requests = Engines.images(Engines.BATCH * Engines.REQUESTS)
    calibration = Engines.images(Engines.CALIBRATION, seed=2)

    # the f32 reference: the same weights on the library route (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    ref = net(torch.from_numpy(requests[:Engines.BATCH]).cuda()).float().cpu()
    net.reset()
    Config.gemmAlgo = Config.convAlgo = "hopper"

    start = time.perf_counter()
    path = Engines.buildEngines(net, workdir, calibration, dtypes=("int8", ))["int8"]
    built = time.perf_counter() - start
    engine = Engine(path)

    size, payload = _engineSizes(net, path)
    print("[engine-int8] calibrated (minmax, %d images in batches of %d) and built in %.2f s; %s: %d bytes, %.3f of "
          "the int8 weights, scales and biases (%d bytes; bound 1.1)" %
          (Engines.CALIBRATION, Engines.CALIBRATION_BATCH, built, os.path.basename(path), size, size / payload,
           payload))

    if not size <= 1.1 * payload:
        fail("the int8 engine file holds %d bytes, above 1.1 x %d" % (size, payload))

    with open(path.replace(".engine", ".graph.txt")) as f:
        recorded = f.read().count("torch.ops.puzzlelib.matmul_nt.default")
    print("[engine-int8] K1-int8 calls in its graph (puzzlelib::matmul_nt): %d" % recorded)

    if recorded != 16:
        fail("the int8 engine's graph records %d puzzlelib::matmul_nt calls, expected 16" % recorded)

    Engines.serve(engine, requests)   # warm-up: allocator blocks of these sizes

    matmul.launches = matmul.launchesInt8 = matmul.launchesInt8Wgmma = winograd.launches = 0
    out, secs = Engines.serve(engine, requests)
    launches = {"int8": matmul.launchesInt8, "int8Wgmma": matmul.launchesInt8Wgmma, "matmul": matmul.launches,
                "winograd": winograd.launches}

    print("[engine-int8] VGG-16 int8 engine, %d images in %d requests of %d: %.4f s, %.1f images/s on %s" %
          (len(requests), Engines.REQUESTS, Engines.BATCH, secs, len(requests) / secs, card))
    print("[engine-int8] launches in that run: K1-int8 %d (on wgmma %d), K1 (float) %d, winograd %d" %
          (launches["int8"], launches["int8Wgmma"], launches["matmul"], launches["winograd"]))

    if launches != {"int8": 16 * Engines.REQUESTS, "int8Wgmma": 16 * Engines.REQUESTS, "matmul": 0, "winograd": 0}:
        fail("expected 64 K1-int8 launches, all 64 on wgmma, and no other, got %s" % launches)

    if out.shape != (len(requests), 1000) or not np.isfinite(out).all():
        fail("logits of shape %s, finite: %s" % (out.shape, np.isfinite(out).all()))

    first = torch.from_numpy(out[:Engines.BATCH])
    cos = (torch.sum(first * ref) / (first.norm() * ref.norm())).item()
    rel = _relL2(first, ref)
    print("[engine-int8] logits of the first request vs the f32 library run: cosine %.6f (bound 0.99), relative L2 "
          "%.3e; logits in [%.4f, %.4f]" % (cos, rel, out.min(), out.max()))

    if not cos >= 0.99:
        fail("int8 logits cosine %.6f against the f32 run" % cos)

    runs = [Engines.serve(engine, requests)[1] for _ in range(5)]
    print("[engine-int8] 5 runs: %s s, median %.1f images/s on %s" %
          (" ".join("%.4f" % t for t in runs), len(requests) / float(np.median(runs)), card))

    del engine
    return net, requests, launches, (path, requests[:Engines.BATCH], out[:Engines.BATCH])


def phaseEngineBf16(torch, card, workdir, net, requests):
    """The bf16 engine of the same net, built on the card, loaded back and
    served with the counters reset just before and read just after, and
    held against the eager bf16 ``Calculator`` on a clone of the net."""
    import copy

    from puzzlelib_tpu_torch.converter.engine import Engine
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    start = time.perf_counter()
    path = Engines.buildEngines(net, workdir, Engines.images(Engines.CALIBRATION, seed=2),
                                dtypes=("bfloat16", ))["bfloat16"]
    built = time.perf_counter() - start
    engine = Engine(path)
    print("[engine-bf16] built in %.2f s; %s: %d bytes" % (built, os.path.basename(path), os.path.getsize(path)))

    clone = copy.deepcopy(net)
    clone.calcMode(torch.bfloat16)

    for module in (engine, clone):
        Engines.serve(module, requests)   # warm-up

    matmul.launches = matmul.launchesWgmma = matmul.launchesInt8 = winograd.launches = 0
    out, secs = Engines.serve(engine, requests)
    launches = {"matmul": matmul.launches, "matmulWgmma": matmul.launchesWgmma, "winograd": winograd.launches,
                "int8": matmul.launchesInt8}

    print("[engine-bf16] VGG-16 bf16 engine, %d images in %d requests of %d: %.4f s, %.1f images/s on %s" %
          (len(requests), Engines.REQUESTS, Engines.BATCH, secs, len(requests) / secs, card))
    print("[engine-bf16] launches in that run: winograd %d, K1 %d (on wgmma %d), K1-int8 %d" %
          (launches["winograd"], launches["matmul"], launches["matmulWgmma"], launches["int8"]))

    if launches != {"matmul": 3 * Engines.REQUESTS, "matmulWgmma": 3 * Engines.REQUESTS,
                    "winograd": 10 * Engines.REQUESTS, "int8": 0}:
        fail("expected 40 Winograd and 12 GEMM launches, all 12 on wgmma, got %s" % launches)

    eager, _ = Engines.serve(clone, requests)
    rel = _relL2(torch.from_numpy(out), torch.from_numpy(eager))
    print("[engine-bf16] logits vs the eager bf16 Calculator on the same clone: relative L2 %.3e (bound 1e-3); "
          "finite %s" % (rel, np.isfinite(out).all()))

    if out.shape != (len(requests), 1000) or not np.isfinite(out).all() or not rel <= 1e-3:
        fail("bf16 engine logits of shape %s, relative L2 %.3e from the eager run" % (out.shape, rel))

    runs = {"engine": [], "eager": []}
    for _ in range(5):
        for label, module in (("engine", engine), ("eager", clone)):
            runs[label].append(Engines.serve(module, requests)[1])

    for label, text in (("engine", "engine"), ("eager", "eager bf16 Calculator")):
        print("[engine-bf16] %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
              (text, " ".join("%.4f" % t for t in runs[label]), len(requests) / float(np.median(runs[label])), card))

    return launches, (path, requests[:Engines.BATCH], out[:Engines.BATCH])


def _visiblePairs(seqQ, seqK, causal):
    """The (query, key) pairs whose scores the softmax weighs: all of them, or
    with the bottom-right causal mask, keys up to i + seqK - seqQ for query i
    (every key for a row that sees none)."""
    if not causal:
        return seqQ * seqK

    return sum(min(seqK, i + seqK - seqQ + 1) if i + seqK - seqQ >= 0 else seqK for i in range(seqQ))


def _ptxasReport(build, source, pattern):
    """Each kernel instance of ``csrc/<source>.cu`` whose mangled name
    ``pattern`` matches, from the build's ``ptxas`` report: ``(match,
    registers, spill stores, spill loads, static shared bytes)``."""
    import re

    log = build.libraryPath(source).with_suffix(".log").read_text()
    found, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(pattern, entry.group(1))
            continue

        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))

        used = re.search(r"Used (\d+) registers", line)
        static = re.search(r"(\d+) bytes smem", line)
        if used and name:
            found.append((name, int(used.group(1)), *spills, int(static.group(1)) if static else 0))
            name, spills = None, (0, 0)

    return found


def _flashInstances(build, flash):
    """Each kernel instance of ``csrc/flash.cu`` with its registers, spill
    stores and loads and static shared memory, and its dynamic shared
    memory: ``(kernel, type, d, registers, spill stores, spill loads, static
    bytes, dynamic bytes)``."""
    found = []
    for name, *report in _ptxasReport(build, "flash", r"(wg|mmaSync)\d+flashForwardI(13__nv_bfloat16|6__half)"
                                                      r"Li(\d+)E(?:Li(\d+)E)?"):
        d = int(name.group(3))
        kernel = "wgmma-%d" % (64 * int(name.group(4))) if name.group(1) == "wg" else "mma"
        found.append((kernel, "bf16" if "bfloat16" in name.group(2) else "f16", d, *report,
                      flash.smemBytes(d, kernel)))
    return sorted(found)


def phaseFlash(torch, flash, build):
    """K4 against its plain version at FLASH_SHAPES in bf16, on the kernel the
    wrapper routes each shape to and on every other path of FLASH_PATHS (the
    wgmma kernel's other block height, the first mma.sync kernel), each held to
    the plain version and the routed one bit-equal on a second call; timed
    in turns, beside the plain version and ``scaled_dot_product_attention``
    (timed as a yardstick, never on the path).  Prints each instance's
    ptxas report and whether the wgmma kernel met its landing rule (printed,
    not a gate: a time is no correctness check).  Returns the JSON entry's
    numbers at the slice's shape, not causal, the one the transformer slice
    runs."""
    import torch.nn.functional as F

    instances = _flashInstances(build, flash)
    for kernel, dtName, d, regs, stores, loads, static, dynamic in instances:
        print("[K4] ptxas %-9s %-4s d %3d: %3d registers, %d bytes spill stores, %d bytes spill loads, %d bytes "
              "static and %d bytes dynamic shared memory" % (kernel, dtName, d, regs, stores, loads, static, dynamic))
    if len(instances) != 3 * 2 * len(flash.HEAD_DIMS):
        fail("the flash build reports %d kernel instances, expected %d" %
             (len(instances), 3 * 2 * len(flash.HEAD_DIMS)))
    if any(kernel != "mma" and stores + loads for kernel, _, _, _, stores, loads, _, _ in instances):
        fail("a wgmma instance of K4 spills")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    main, ratios = None, []

    for name, (b, h, seqQ, d), seqK, causal in FLASH_SHAPES:
        q, k, v = [torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for seq in (seqQ, seqK, seqK)]
        routed = "wgmma-%d" % flash.blockRows(seqQ, b * h, d, sms)

        ref, refLse = flash.plain(q, k, v, causal)
        out, lse = flash.flash(q, k, v, causal)
        again = flash.flash(q, k, v, causal)
        torch.cuda.synchronize()
        repeats = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        absOut = (out.float() - ref.float()).abs().max().item()
        del again

        errs = {}
        for path in FLASH_PATHS:
            got, gotLse = (out, lse) if path == routed else flash._launch(q, k, v, causal, path)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all()) and bool(torch.isfinite(gotLse).all())
            errs[path] = (relErr(torch, got, ref), relErr(torch, gotLse, refLse))
            if not finite:
                fail("K4 %s on %s gave values that are not finite" % ((b, h, seqQ, seqK, d, causal), path))
            del got, gotLse
        del out, lse, ref, refLse

        # the library's causal flag aligns top-left; bottom-right is a mask
        mask = None
        if causal and seqQ != seqK:
            mask = torch.ones((seqQ, seqK), dtype=torch.bool, device="cuda").tril(diagonal=seqK - seqQ)

        others = [path for path in FLASH_PATHS if path != routed]
        times, _ = _medianTurns([lambda: flash.flash(q, k, v, causal)] +
                                 [lambda path=path: flash._launch(q, k, v, causal, path) for path in others])
        ms, pathMs = times[0], dict(zip([routed] + others, times))
        plainMs = deviceMs(lambda: flash.plain(q, k, v, causal), 2)
        libMs = deviceMs(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None), 10)

        nbytes = (2 * b * h * seqQ * d + 2 * b * h * seqK * d) * 2 + b * h * seqQ * 4
        boundMs, boundBy = bound(nbytes, 4 * b * h * d * _visiblePairs(seqQ, seqK, causal))

        print("[K4] %-6s (b, h, seqQ, d) = %s, seqK %d, causal %-5s on %s: out rel err %.3e (bound %.0e), lse rel "
              "err %.3e (bound %.0e), second call %s; kernel %.4f ms; wgmma-64 %.4f ms, wgmma-128 %.4f ms, mma.sync "
              "(the yardstick) %.4f ms (%.3fx of it); plain %.4f ms, scaled_dot_product_attention %.4f ms, bound "
              "%.4f ms (%s)" %
              (name, (b, h, seqQ, d), seqK, causal, routed, errs[routed][0], FLASH_BOUND_OUT, errs[routed][1],
               FLASH_BOUND_LSE, "bit-equal" if repeats else "DIFFERENT", ms, pathMs["wgmma-64"],
               pathMs["wgmma-128"], pathMs["mma"], ms / pathMs["mma"], plainMs, libMs, boundMs, boundBy))
        print("[K4] %-6s the other paths against plain: %s" %
              (name, ", ".join("%s out %.3e, lse %.3e" % (path, *errs[path]) for path in others)))

        for path, (errOut, errLse) in errs.items():
            if not (errOut <= FLASH_BOUND_OUT and errLse <= FLASH_BOUND_LSE):
                fail("K4 %s on %s disagrees with its plain version: out %.3e, lse %.3e" %
                     ((b, h, seqQ, seqK, d, causal), path, errOut, errLse))

        if not repeats:
            fail("K4 %s gives other bits on a second call" % ((b, h, seqQ, seqK, d, causal), ))

        ratios.append((name, (b, h, seqQ, d), seqK, causal, ms / pathMs["mma"]))
        if main is None:
            main = {"max_abs_err": absOut, "ms": ms, "mma_ms": pathMs["mma"], "plain_ms": plainMs,
                    "bound_ms": boundMs, "bound_by": boundBy, "library_ms": libMs}

    # the landing rule: faster than the mma.sync kernel at every long shape and
    # at the engine's, no more than 5 % slower at the short ones
    short = [r for r in ratios if r[0] in ("slice", "offset")]
    longer = [r for r in ratios if r[0] not in ("slice", "offset")]
    met = all(r[-1] < 1.0 for r in longer) and all(r[-1] <= 1.05 for r in short)
    print("[K4] wgmma against mma.sync (same call): %s; faster at every long and engine shape and within 5 %% at "
          "every short one: %s" % (", ".join("%s %s/%d%s %.3fx" % (r[0], r[1], r[2], " causal" if r[3] else "", r[4])
                                             for r in ratios), "yes" if met else "NO"))

    torch.cuda.empty_cache()
    return main


def phaseFlashBackward(torch, flash):
    """K5a and K5b against ``backwardPlain`` at FLASH_BWD_SHAPES in bf16,
    beside the backward of ``scaled_dot_product_attention`` (the autograd
    backward of its output, forward excluded; timed as a yardstick, never on
    the path).  Returns the JSON entries' numbers (K5a, K5b) at the slice's
    shape, not causal, the one the transformer slice runs, each with the
    whole ``flash.backward`` (delta pass and both kernels) as
    ``backward_ms``, the time to set beside the library's whole backward."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    entries = None

    for name, (b, h, seqQ, d), seqK, causal in FLASH_BWD_SHAPES:
        q, k, v, do = [torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for seq in (seqQ, seqK, seqK, seqQ)]
        out, lse = flash.flash(q, k, v, causal)

        got = flash.backward(q, k, v, out, lse, do, causal)
        want = flash.backwardPlain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()

        errs = [relErr(torch, g, w) for g, w in zip(got, want)]
        absErrs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del got, want

        delta = (do.float() * out.float()).sum(dim=-1).contiguous()
        msDq = deviceMs(lambda: flash.dq(q, k, v, do, lse, delta, causal), 10)
        msDkv = deviceMs(lambda: flash.dkv(q, k, v, do, lse, delta, causal), 10)
        msAll = deviceMs(lambda: flash.backward(q, k, v, out, lse, do, causal), 10)
        plainMs = deviceMs(lambda: flash.backwardPlain(q, k, v, out, lse, do, causal), 2)

        # the library's causal flag aligns top-left; bottom-right is a mask
        mask = None
        if causal and seqQ != seqK:
            mask = torch.ones((seqQ, seqK), dtype=torch.bool, device="cuda").tril(diagonal=seqK - seqQ)

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        libOut = F.scaled_dot_product_attention(*leaves, attn_mask=mask, is_causal=causal and mask is None)
        libMs = deviceMs(lambda: torch.autograd.grad(libOut, leaves, do, retain_graph=True), 10)
        del libOut, leaves

        # bytes: q, dO, k and v read in bf16, lse and delta in f32, and the
        # kernel's outputs written; operations: 3 products in K5a, 4 in K5b,
        # 2 * d per visible (query, key) pair each; 10 for a fused backward
        pairs = b * h * d * _visiblePairs(seqQ, seqK, causal)
        inputs = (2 * b * h * seqQ * d + 2 * b * h * seqK * d) * 2 + 2 * b * h * seqQ * 4
        boundDq, byDq = bound(inputs + b * h * seqQ * d * 2, 6 * pairs)
        boundDkv, byDkv = bound(inputs + 2 * b * h * seqK * d * 2, 8 * pairs)
        boundFused, _ = bound(inputs + (b * h * seqQ * d + 2 * b * h * seqK * d) * 2, 10 * pairs)

        print("[K5] %-6s (b, h, seqQ, d) = %s, seqK %d, causal %-5s: rel err dq %.3e, dk %.3e, dv %.3e (bound %.0e); "
              "K5a %.4f ms (bound %.4f, %s), K5b %.4f ms (bound %.4f, %s), backward with delta %.4f ms (delta and "
              "set-up %.4f ms); plain %.4f ms; scaled_dot_product_attention backward %.4f ms; a fused backward's "
              "bound %.4f ms" % (name, (b, h, seqQ, d), seqK, causal, *errs, FLASH_BWD_BOUND, msDq, boundDq, byDq,
                                 msDkv, boundDkv, byDkv, msAll, msAll - msDq - msDkv, plainMs, libMs, boundFused))

        if not finite:
            fail("K5 %s gave values that are not finite" % ((b, h, seqQ, seqK, d, causal), ))

        if not all(err <= FLASH_BWD_BOUND for err in errs):
            fail("K5 %s disagrees with its plain version: dq %.3e, dk %.3e, dv %.3e" %
                 (((b, h, seqQ, seqK, d, causal), ) + tuple(errs)))

        if entries is None:
            entries = ({"max_abs_err": absErrs[0], "ms": msDq, "plain_ms": plainMs, "bound_ms": boundDq,
                        "bound_by": byDq, "library_ms": libMs, "backward_ms": msAll},
                       {"max_abs_err": max(absErrs[1:]), "ms": msDkv, "plain_ms": plainMs, "bound_ms": boundDkv,
                        "bound_by": byDkv, "library_ms": libMs, "backward_ms": msAll})

    torch.cuda.empty_cache()
    return entries


def _setAttention(net, algo):
    from puzzlelib_tpu_torch.modules import MultiHeadAttention

    for module in net.modules():
        if isinstance(module, MultiHeadAttention):
            module.attnAlgo = algo


def _namedGrads(net, names):
    variables = {name: var for var, aliases in net.getVarTable().items() for name in aliases}
    return {name: variables[name].grad.float().clone() for name in names}


def phaseTransformerTrain(torch, card):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

    config = Slice.CONFIG
    routes, tokens, labels = Slice.buildTraining()
    hand = routes["hopper"]

    # warm-up of both routes: allocator blocks of these sizes, cuBLAS handles
    for algo in ("torch", "hopper"):
        Slice.train(routes, algo, tokens, labels)

    # the first step's gradients: one forward of the first batch on the hand
    # kernels, then its backward on the hand kernels (K5a / K5b) and on the
    # library route (the composed attention's VJP, cuBLAS)
    hand.restore()
    Config.gemmAlgo = "hopper"
    net = hand.net
    net.trainMode()
    grad = hand.trainer.cost(net(gpuarray.to_gpu(tokens[:Slice.BATCH])), gpuarray.to_gpu(labels[:Slice.BATCH]),
                             queryError=False)

    grads = {}
    for algo, attention in (("hopper", "flash"), ("torch", "xla")):
        Config.gemmAlgo = algo
        _setAttention(net, attention)
        hand.optimizer.zeroGradParams()
        net.backward(grad, updGrad=False)
        grads[algo] = _namedGrads(net, TRANSFORMER_GRADS)

    _setAttention(net, "flash")
    Config.gemmAlgo = "hopper"
    net.reset()

    for name in TRANSFORMER_GRADS:
        rel = _relL2(grads["hopper"][name], grads["torch"][name])
        print("[transformer-train] first-step gradient of %-13s: hand kernels vs library route's backward, same "
              "forward: relative L2 %.3e (bound %.0e)" % (name, rel, TRAIN_BOUND))

        if not rel <= TRAIN_BOUND:
            fail("first-step gradient of %s on the hand kernels differs from the library's by %.3e" % (name, rel))

    # the counted run
    variables = list(net.getVarTable())
    snapshot = [var.data.clone() for var in variables]

    losses = []
    flash.launches = flash.launchesWgmma = flash.launchesDq = flash.launchesDkv = 0
    matmul.launches = matmul.launchesWgmma = winograd.launches = 0
    secs = Slice.train(routes, "hopper", tokens, labels, losses)
    launches = {"flash": flash.launches, "flashWgmma": flash.launchesWgmma, "flashDq": flash.launchesDq,
                "flashDkv": flash.launchesDkv, "matmul": matmul.launches, "matmulWgmma": matmul.launchesWgmma,
                "winograd": winograd.launches}

    print("[transformer-train] IMDB transformer bf16 (vocab %d, seq %d, emb %d, %d heads, %d layers), Adam, %d rows "
          "in %d steps of %d: %.4f s, %.1f rows/s on %s" %
          (config["vocabsize"], config["seqlen"], config["embsize"], config["nheads"], config["nlayers"],
           len(tokens), Slice.STEPS, Slice.BATCH, secs, len(tokens) / secs, card))
    print("[transformer-train] launches in that run: flash forward %d (on wgmma %d), flash dq %d, flash dk/dv %d, "
          "matmul %d (on wgmma %d), winograd %d" %
          (launches["flash"], launches["flashWgmma"], launches["flashDq"], launches["flashDkv"], launches["matmul"],
           launches["matmulWgmma"], launches["winograd"]))

    # per step: one K4 (on wgmma), one K5a and one K5b launch per attention
    # layer (the backward reuses the forward's lse), one K1 launch per Linear
    # forward, on wgmma but for the head's N = 2
    perLayer = config["nlayers"] * Slice.STEPS
    expected = {"flash": perLayer, "flashWgmma": perLayer, "flashDq": perLayer, "flashDkv": perLayer,
                "matmul": sum(count for *_, count in Slice.GEMMS) * Slice.STEPS,
                "matmulWgmma": _wgmmaGemms() * Slice.STEPS, "winograd": 0}
    if launches != expected:
        fail("expected launches %s, got %s" % (expected, launches))

    print("[transformer-train] step losses: %s" % " ".join("%.6f" % loss for loss in losses))
    if len(losses) != Slice.STEPS or not np.isfinite(losses).all():
        fail("step losses %s" % losses)

    packs = {dtype: (pack.ary.untyped_storage().data_ptr(), hand.optimizer.shGrads[dtype].ary.untyped_storage()
                     .data_ptr()) for dtype, pack in hand.optimizer.shParams.items()}
    for var, old in zip(variables, snapshot):
        if (var.data.untyped_storage().data_ptr(), var.grad.untyped_storage().data_ptr()) != packs[var.data.dtype]:
            fail("variable %s is no view of the optimizer's flat buffers" % var.name)

        if torch.equal(var.data, old):
            fail("variable %s did not change in training" % var.name)

    print("[transformer-train] all %d variables are views of the flat buffers (%s) and changed" %
          (len(variables), ", ".join(str(dtype) for dtype in packs)))
    del snapshot

    # the same run again from the same start must repeat bit for bit
    embedGrad = _namedGrads(net, ("embed.W", ))["embed.W"]
    again = []
    Slice.train(routes, "hopper", tokens, labels, again)
    repeats = again == losses and torch.equal(_namedGrads(net, ("embed.W", ))["embed.W"], embedGrad)
    print("[transformer-train] a second run from the same start: losses %s; bit-equal to the first (losses and the "
          "last step's embed.W gradient): %s" % (" ".join("%.6f" % loss for loss in again), repeats))

    if not repeats:
        fail("the bf16 training run does not repeat: losses %s, then %s" % (losses, again))

    libLosses = []
    Slice.train(routes, "torch", tokens, labels, libLosses)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, libLosses))
    print("[transformer-train] library route step losses: %s; largest relative difference %.3e (bound %.0e)" %
          (" ".join("%.6f" % loss for loss in libLosses), rel, TRAIN_BOUND))

    if not rel <= TRAIN_BOUND:
        fail("step losses differ from the library route's by %.3e" % rel)

    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo].append(Slice.train(routes, algo, tokens, labels))
    Config.gemmAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels (K4, K5a, K5b flash, K1 GEMM)"),
                        ("torch", "library route (composed attention, cuBLAS)")):
        print("[transformer-train] %s, 5 runs in turns: %s s, median %.1f rows/s on %s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(tokens) / float(np.median(runs[algo])), card))

    return launches


def _wgmmaGemms():
    """The transformer slice's K1 launches a request (or step) whose operands
    TMA can describe (K and N multiples of 8), which therefore go to wgmma:
    every Linear but the head, whose N = 2."""
    return sum(count for _, _, k, n, count in Slice.GEMMS if k % 8 == 0 and n % 8 == 0)


def phaseTransformer(torch, card):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

    config = Slice.CONFIG
    routes, tokens = Slice.build()

    # the f32 reference: the same weights on the library route (TF32 off)
    Config.gemmAlgo = "torch"
    lib = routes["torch"]
    lib.evalMode()
    refLogits = lib(torch.from_numpy(tokens[:Slice.BATCH]).cuda()).float().clone()
    lib.reset()

    for net in routes.values():
        net.calcMode(torch.bfloat16)

    for algo in ("torch", "hopper"):
        Slice.serve(routes, algo, tokens)

    flash.launches = flash.launchesWgmma = matmul.launches = matmul.launchesWgmma = winograd.launches = 0
    out, secs = Slice.serve(routes, "hopper", tokens)
    launches = {"flash": flash.launches, "flashWgmma": flash.launchesWgmma, "matmul": matmul.launches,
                "matmulWgmma": matmul.launchesWgmma, "winograd": winograd.launches}

    print("[transformer] IMDB transformer bf16 (vocab %d, seq %d, emb %d, %d heads, %d layers), %d rows in %d "
          "requests of %d: %.4f s, %.1f rows/s on %s" %
          (config["vocabsize"], config["seqlen"], config["embsize"], config["nheads"], config["nlayers"],
           len(tokens), Slice.REQUESTS, Slice.BATCH, secs, len(tokens) / secs, card))
    print("[transformer] launches in that run: flash %d (on wgmma %d), matmul %d (on wgmma %d), winograd %d" %
          (launches["flash"], launches["flashWgmma"], launches["matmul"], launches["matmulWgmma"],
           launches["winograd"]))

    # per request: one K4 launch per attention layer, on wgmma, one K1 launch
    # per Linear (two MLP layers per block and the head's classifier), on
    # wgmma but for the head's N = 2
    expected = {"flash": config["nlayers"] * Slice.REQUESTS, "flashWgmma": config["nlayers"] * Slice.REQUESTS,
                "matmul": sum(count for *_, count in Slice.GEMMS) * Slice.REQUESTS,
                "matmulWgmma": _wgmmaGemms() * Slice.REQUESTS, "winograd": 0}
    if launches != expected:
        fail("expected launches %s, got %s" % (expected, launches))

    if out.shape != (len(tokens), config["nclasses"]) or not np.isfinite(out).all():
        fail("output of shape %s, finite: %s" % (out.shape, np.isfinite(out).all()))

    libOut, _ = Slice.serve(routes, "torch", tokens)

    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            runs[algo].append(Slice.serve(routes, algo, tokens)[1])
    Config.gemmAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels (K4 flash, K1 GEMM)"),
                        ("torch", "library route (composed attention, cuBLAS)")):
        print("[transformer] %s, 5 runs in turns: %s s, median %.1f rows/s on %s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(tokens) / float(np.median(runs[algo])), card))

    first = torch.from_numpy(out[:Slice.BATCH])
    rel = _relL2(first, refLogits.cpu())
    relLib = _relL2(first, torch.from_numpy(libOut[:Slice.BATCH]))

    print("[transformer] logits of the first request vs the f32 library run: relative L2 %.3e (bound %.0e); vs the "
          "bf16 library route %.3e; logits in [%.4f, %.4f]" % (rel, SLICE_BOUND, relLib, out.min(), out.max()))

    if not rel <= SLICE_BOUND:
        fail("logits relative L2 error %.3e against the f32 run" % rel)

    return launches


def phaseStreamCopy(torch, streamcopy):
    """P3 against its plain version, bit for bit, on the roofline probe's 64
    Mi bf16 values, and in f16, f32 and a ragged length; beside
    ``torch.add(x, 1)``.  Returns the JSON entry's numbers at the probe's
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    for dtype, shape in ((torch.float16, STREAM_SHAPE), (torch.float32, STREAM_SHAPE), (torch.bfloat16, (1001, ))):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if not torch.equal(streamcopy.addOne(x), streamcopy.plain(x)):
            fail("P3 differs from its plain version in %s at %s" % (dtype, shape))

    x = torch.randn(STREAM_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    y, ref = streamcopy.addOne(x), streamcopy.plain(x)
    torch.cuda.synchronize()
    exact = torch.equal(y, ref)
    absErr = (y.float() - ref.float()).abs().max().item()
    del y, ref

    (ms, libMs), (runs, libRuns) = _medianTurns([lambda: streamcopy.addOne(x), lambda: torch.add(x, 1)],
                                                 LAUNCH_FLOOR_CALLS, LAUNCH_FLOOR_TURNS)
    plainMs = deviceMs(lambda: streamcopy.plain(x), 20)
    nbytes = 2 * x.numel() * x.element_size()
    boundMs, boundBy = bound(nbytes, x.numel(), F32_FLOP_PER_S)

    print("[P3-roofline] x + 1 on %s bf16: %s (max |kernel - plain| %.1e; f16, f32 and a ragged 1001 exact too); "
          "medians of %d alternating turns of %d calls: kernel %.5f ms (turns %s), %.1f GB/s (%.1f %% of 3.35 TB/s); "
          "library (torch.add) %.5f ms (turns %s), %.1f GB/s; kernel / library %.3f; plain %.4f ms; bound %.4f ms "
          "(%s)" % (STREAM_SHAPE, "exact" if exact else "NOT EXACT", absErr, LAUNCH_FLOOR_TURNS, LAUNCH_FLOOR_CALLS,
                    ms, ", ".join("%.5f" % t for t in runs), nbytes / ms / 1e6, nbytes / ms / 1e6 / 33.5, libMs,
                    ", ".join("%.5f" % t for t in libRuns), nbytes / libMs / 1e6, ms / libMs, plainMs, boundMs,
                    boundBy))

    if not exact:
        fail("P3 differs from its plain version by up to %.3e" % absErr)

    return {"max_abs_err": absErr, "ms": ms, "plain_ms": plainMs, "bound_ms": boundMs, "bound_by": boundBy,
            "library_ms": libMs}


def phasePhaseSplit(torch, phasesplit):
    """P2 against its plain version (the permuted copy, also the library's
    way), bit for bit, at PHASE_SHAPES.  Returns the JSON entry's numbers at
    the probe's own shape."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    main = None

    for shape, rows in PHASE_SHAPES:
        n, h, w, c = shape
        x6 = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).reshape(n, h // 2, 2, w // 2, 2, c)
        geometry = dict(rows=rows, tw=w // 2, c=c, nTiles=(h // 2) // rows)

        out, ref = phasesplit.phaseSplit(x6, **geometry), phasesplit.plain(x6, **geometry)
        torch.cuda.synchronize()
        exact = torch.equal(out, ref)
        absErr = (out.float() - ref.float()).abs().max().item()

        ms = deviceMs(lambda: phasesplit.phaseSplit(x6, **geometry), 20)
        plainMs = deviceMs(lambda: phasesplit.plain(x6, **geometry), 20)
        nbytes = 2 * out.numel() * out.element_size()
        boundMs, boundBy = bound(nbytes, 0)

        print("[P2-phasesplit] x %s bf16, %d rows a tile: %s; kernel %.4f ms, %.1f GB/s; plain = library (permuted "
              ".contiguous()) %.4f ms, %.1f GB/s; bound %.5f ms (%s)" %
              (shape, rows, "exact" if exact else "NOT EXACT", ms, nbytes / ms / 1e6, plainMs, nbytes / plainMs / 1e6,
               boundMs, boundBy))

        if not exact:
            fail("P2 at %s differs from its plain version by up to %.3e" % (shape, absErr))

        if main is None:
            main = {"max_abs_err": absErr, "ms": ms, "plain_ms": plainMs, "bound_ms": boundMs, "bound_by": boundBy,
                    "library_ms": plainMs}

    return main


def _tapdotInstances(build):
    """Each kernel instance of ``csrc/tapdot.cu`` with its registers, spill
    stores and loads and static shared memory: ``(kernel, type, channel
    chunk, registers, spill stores, spill loads, static bytes)``."""
    return sorted(("wgmma" if name.group(1) == "wg" else "mma", "bf16" if "bfloat16" in name.group(2) else "f16",
                   int(name.group(3) or 32), *report)
                  for name, *report in _ptxasReport(build, "tapdot", r"(wg|mmaSync)\d+tapdot(?:Wgmma|Mma)I"
                                                                     r"(13__nv_bfloat16|6__half)(?:Li(\d+)E)?"))


def _tapdotCase(torch, tapdot, gen, xshape, co, dtype):
    """P1 on seeded operands of one 3x3 pad-1 conv through both kernels:
    (operands, {path: (relative L2 against the plain version, max relative
    error of the conv against the f32 conv, max |kernel - plain|)})."""
    import torch.nn.functional as F

    x = (torch.randn(xshape, generator=gen, device="cuda") * 0.3).to(dtype)
    w = (torch.randn((co, xshape[1], 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
    xp, wk, geometry, (oh, ow) = tapdot.layout(x, w, (1, 1))

    ref = tapdot.plain(xp, wk, **geometry)
    f32 = F.conv2d(x.float(), w.float(), padding=1)
    errs = {}
    for path in TAPDOT_PATHS:
        got = tapdot.tapdot(xp, wk, **geometry) if path == "wgmma" else tapdot._launch(xp, wk, **geometry, path=path)
        torch.cuda.synchronize()
        errs[path] = (_relL2(got.float(), ref.float()), relErr(torch, tapdot.crop(got, geometry, oh, ow), f32),
                      (got.float() - ref.float()).abs().max().item())
        del got
    return (x, w, xp, wk, geometry), errs


def _tapdotHeld(name, errs):
    """Fails unless every path of ``errs`` is within both bounds."""
    for path, (errPlain, errF32, _) in errs.items():
        if not (errPlain <= TAPDOT_BOUND_PLAIN and errF32 <= TAPDOT_BOUND_F32):
            fail("P1 %s on %s disagrees: %.3e vs plain, %.3e vs f32" % (name, path, errPlain, errF32))


def phaseTapdot(torch, tapdot, winograd, build):
    """P1 on both kernels (``wgmma``, the one ``tapdot`` takes, and the first
    ``mma.sync`` kernel, the yardstick) against its plain version and the f32
    conv (TF32 off) at TAPDOT_SHAPES and the ragged ones.  At the five shapes
    both kernels, cuDNN (``F.conv2d`` on channels-last bf16) and K2 on the
    same channels-last operands are timed in turns; K2 on NCHW operands
    (its wrapper's layout copies in the timed call), P1's layout pass and
    the plain version apart.  The kernels run on the operands
    ``tapdot.layout`` prepared.  Prints each instance's ptxas report (a
    spill in a wgmma instance fails), each shape's channel chunk and shared
    memory, and whether the wgmma kernel beat the yardstick at every shape
    (printed, not a gate: a time is no correctness check).  Returns the
    JSON entry's numbers for the five timed shapes together."""
    import torch.nn.functional as F

    instances = _tapdotInstances(build)
    for kernel, dtName, chunk, regs, stores, loads, static in instances:
        print("[P1-tapdot] ptxas %-5s %-4s chunk %d: %3d registers, %d bytes spill stores, %d bytes spill loads, %d "
              "bytes static shared memory" % (kernel, dtName, chunk, regs, stores, loads, static))
    if sorted((kernel, dtName, chunk) for kernel, dtName, chunk, *_ in instances) != sorted(
            [("wgmma", dt, chunk) for dt in ("bf16", "f16") for chunk in (32, 64)] +
            [("mma", dt, 32) for dt in ("bf16", "f16")]):
        fail("the tapdot build reports the instances %s" % [instance[:3] for instance in instances])
    if any(kernel == "wgmma" and stores + loads for kernel, _, _, _, stores, loads, _ in instances):
        fail("a wgmma instance of P1 spills")

    gen = torch.Generator(device="cuda").manual_seed(13)
    main = {"max_abs_err": 0.0, "ms": 0.0, "mma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    ratios = []

    for name, xshape, co, dtName in TAPDOT_RAGGED:
        _, errs = _tapdotCase(torch, tapdot, gen, xshape, co, torch.float16 if dtName == "f16" else torch.bfloat16)
        print("[P1-tapdot] %-10s x=%s co=%d %s: %s" % (name, xshape, co, dtName, "; ".join(
            "%s relative L2 %.3e vs plain (bound %.0e), %.3e vs f32 (bound %.0e)" %
            (path, errPlain, TAPDOT_BOUND_PLAIN, errF32, TAPDOT_BOUND_F32)
            for path, (errPlain, errF32, _) in errs.items())))
        _tapdotHeld(name, errs)

    for name, xshape, co in TAPDOT_SHAPES:
        (x, w, xp, wk, geometry), errs = _tapdotCase(torch, tapdot, gen, xshape, co, torch.bfloat16)
        _tapdotHeld(name, errs)
        xl, wl = x.contiguous(memory_format=torch.channels_last), w.contiguous(memory_format=torch.channels_last)

        fns = [lambda: tapdot.tapdot(xp, wk, **geometry), lambda: tapdot._launch(xp, wk, **geometry, path="mma"),
               lambda: F.conv2d(xl, wl, padding=1)]
        k2 = winograd.applicable(tuple(x.shape), tuple(w.shape), (1, 1), (1, 1), (1, 1), 1)
        if k2:
            fns.append(lambda: winograd.conv2d(xl, wl, (1, 1)))
        times, _ = _medianTurns(fns)
        ms, mmaMs, libMs = times[:3]
        k2Text = "n/a"
        if k2:
            k2Text = "%.4f ms on channels-last operands, %.4f ms on NCHW ones" % (
                times[3], deviceMs(lambda: winograd.conv2d(x, w, (1, 1)), 10))
        layoutMs = deviceMs(lambda: tapdot.layout(x, w, (1, 1)), 10)
        plainMs = deviceMs(lambda: tapdot.plain(xp, wk, **geometry), 2)

        n, c, h, wd = xshape
        flops = 2.0 * n * co * h * wd * c * 9
        boundMs, boundBy = bound((n * c * h * wd + n * co * h * wd + co * c * 9) * 2, flops)
        chunk, smem = tapdot.launchShape(geometry["wp"], 3, 3)

        print("[P1-tapdot] %-10s x=%s co=%d: wgmma relative L2 %.3e vs plain (bound %.0e), %.3e vs f32 (bound "
              "%.0e), mma.sync %.3e, %.3e; on laid-out operands, in turns: wgmma %.4f ms, %.1f TFLOP/s useful (chunk "
              "%d, %d bytes of dynamic shared memory), mma.sync (the yardstick) %.4f ms, %.1f TFLOP/s (wgmma %.3fx "
              "of it), library (cuDNN, channels-last) %.4f ms, K2 %s; its layout pass (tapdot.layout) %.4f ms; plain "
              "%.4f ms; bound %.4f ms (%s)" %
              (name, xshape, co, errs["wgmma"][0], TAPDOT_BOUND_PLAIN, errs["wgmma"][1], TAPDOT_BOUND_F32,
               errs["mma"][0], errs["mma"][1], ms, flops / ms / 1e9, chunk, smem, mmaMs, flops / mmaMs / 1e9,
               ms / mmaMs, libMs, k2Text, layoutMs, plainMs, boundMs, boundBy))

        ratios.append((name, ms / mmaMs))
        main["max_abs_err"] = max(main["max_abs_err"], errs["wgmma"][2])
        for key, value in (("ms", ms), ("mma_ms", mmaMs), ("plain_ms", plainMs), ("library_ms", libMs),
                           ("bound_ms", boundMs)):
            main[key] += value
        main["bound_by"] = boundBy

        del x, w, xp, wk, xl, wl
        torch.cuda.empty_cache()

    print("[P1-tapdot] wgmma against mma.sync (same call): %s; faster at every timed shape: %s" %
          (", ".join("%s %.3fx" % r for r in ratios), "yes" if all(r[1] < 1.0 for r in ratios) else "NO"))
    return main


def phaseMeasurementPath(torch, card):
    """The measurement entry points as a user runs them, with every kernel's
    counter reset just before and read just after: the three probe scripts
    (``tools/roofline_probe``, ``strided_dma_probe``, ``tapdot_probe``) and
    the benchmarks (``gemmspeed`` at its defaults, ``--kernel-rate`` and
    ``--tune`` at 1024 and 4096, ``kernelspeed``, ``convspeed`` on VGG-16's
    conv3_2 in bf16 and its ``--chain``, each racing the conv first,
    ``attnspeed`` at its defaults, which records its winners).
    Every kernel of the path must have run."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.benchmarks import attnspeed, convspeed, gemmspeed, kernelspeed
    from puzzlelib_tpu_torch.ops import conv
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, phasesplit, streamcopy, tapdot, winograd
    from puzzlelib_tpu_torch.tools import roofline_probe, strided_dma_probe, tapdot_probe

    Config.device = "cuda"
    Config.gemmAlgo = Config.convAlgo = "hopper"
    vgg = ["--dtype", "bfloat16", "--data", "%d,256,56,56" % BATCH, "--weights", "256,256,3,3", "--pad", "1"]

    counters = [(streamcopy, "launches"), (phasesplit, "launches"), (tapdot, "launches"), (tapdot, "launchesWgmma"),
                (matmul, "launches"),
                (matmul, "launchesWgmma"), (matmul, "launchesInt8"), (matmul, "launchesInt8Wgmma"),
                (winograd, "launches"),
                (winograd, "dataGradLaunches"), (winograd, "filterGradLaunches"), (flash, "launches"),
                (flash, "launchesWgmma"), (flash, "launchesDq"), (flash, "launchesDkv")]
    for module, counter in counters:
        setattr(module, counter, 0)

    start = time.perf_counter()
    for label, run in (("tools/roofline_probe", lambda: roofline_probe.main([])),
                       ("tools/strided_dma_probe", lambda: strided_dma_probe.main([])),
                       ("tools/tapdot_probe", lambda: tapdot_probe.main([])),
                       ("benchmarks/gemmspeed", lambda: gemmspeed.main([])),
                       ("benchmarks/gemmspeed --kernel-rate", lambda: gemmspeed.main(["--kernel-rate"])),
                       ("benchmarks/gemmspeed --tune", lambda: gemmspeed.main(["--tune", "--sizes", "1024,4096",
                                                                              "--iters", "10"])),
                       ("benchmarks/kernelspeed", lambda: kernelspeed.main(["--iters", "10"])),
                       ("benchmarks/convspeed", lambda: convspeed.cli(vgg)),
                       ("benchmarks/convspeed --chain", lambda: convspeed.cli(vgg + ["--chain"])),
                       ("benchmarks/attnspeed", lambda: attnspeed.main([]))):
        print("[measure] --- %s ---" % label)
        run()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - start
    conv.resetDispatchCaches()   # the benchmarks' races, which no later phase reads

    launches = {"P3": streamcopy.launches, "P2": phasesplit.launches, "P1": tapdot.launches,
                "P1-wgmma": tapdot.launchesWgmma, "K1": matmul.launches,
                "K1-wgmma": matmul.launchesWgmma, "K1-int8": matmul.launchesInt8,
                "K1-int8-wgmma": matmul.launchesInt8Wgmma,
                "K2": winograd.launches - winograd.dataGradLaunches,
                "K2-bwd": winograd.dataGradLaunches, "K3": winograd.filterGradLaunches, "K4": flash.launches,
                "K4-wgmma": flash.launchesWgmma, "K5a": flash.launchesDq, "K5b": flash.launchesDkv}

    print("[measure] the probes and benchmarks ran in %.2f s on %s; launches in that run: %s" %
          (secs, card, ", ".join("%s %d" % item for item in launches.items())))

    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        fail("the measurement path launched no %s" % ", ".join(missing))

    if launches["P1-wgmma"] != launches["P1"]:
        fail("%d of the measurement path's %d P1 launches ran on the wgmma kernel, expected all" %
             (launches["P1-wgmma"], launches["P1"]))

    return launches


def phaseEngineFlash(torch, card, workdir):
    """A bf16 engine of a float-input attention net at seq 1024, where the
    "auto" attention is flash on the card: built, reloaded and served 4
    requests through ``Calculator``, with the counters reset just before and
    read just after; K4 recorded as ``puzzlelib::flash`` in the graph and
    launched once a request; the logits equal to the eager bf16 net's on a
    clone."""
    import copy

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch import containers, modules
    from puzzlelib_tpu_torch.converter.engine import Engine, buildEngine
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = True
    Config.gemmAlgo = Config.convAlgo = "hopper"
    batch, seq, emb, heads = (ATTN_NET[key] for key in ("batch", "seq", "emb", "heads"))

    np.random.seed(0)
    net = containers.Sequential(name="attn-net")
    net.append(modules.LayerNorm(emb, name="norm"))
    net.append(modules.MultiHeadAttention(emb, heads, name="attn"))
    requests = np.random.RandomState(1).randn(batch * REQUESTS, seq, emb).astype(np.float32)

    start = time.perf_counter()
    path = buildEngine(net, (batch, seq, emb), workdir, dtype="bfloat16", returnEngine=False)
    built = time.perf_counter() - start

    with open(path.replace(".engine", ".graph.txt")) as f:
        recorded = f.read().count("torch.ops.puzzlelib.flash.default")
    engine = Engine(path)
    print("[engine-flash] attention net (LayerNorm, MultiHeadAttention emb %d, %d heads, attnAlgo %r) at (%d, %d, "
          "%d), bf16 engine built in %.2f s; K4 calls in its graph: %d" %
          (emb, heads, net["attn"].attnAlgo, batch, seq, emb, built, recorded))

    if recorded != 1:
        fail("the flash engine's graph records %d puzzlelib::flash calls, expected 1" % recorded)

    clone = copy.deepcopy(net)
    clone.calcMode(torch.bfloat16)
    for module in (engine, clone):
        Engines.serve(module, requests, batch=batch)   # warm-up

    flash.launches = flash.launchesWgmma = matmul.launches = winograd.launches = 0
    out, secs = Engines.serve(engine, requests, batch=batch)
    launches = {"flash": flash.launches, "flashWgmma": flash.launchesWgmma, "matmul": matmul.launches,
                "winograd": winograd.launches}

    print("[engine-flash] %d requests of %d: %.4f s, %.1f rows/s on %s; launches in that run: flash %d (on wgmma "
          "%d), matmul %d, winograd %d" % (REQUESTS, batch, secs, len(requests) / secs, card, launches["flash"],
                                           launches["flashWgmma"], launches["matmul"], launches["winograd"]))

    if launches != {"flash": REQUESTS, "flashWgmma": REQUESTS, "matmul": 0, "winograd": 0}:
        fail("expected %d K4 launches, all on wgmma, and no other, got %s" % (REQUESTS, launches))

    eager, _ = Engines.serve(clone, requests, batch=batch)
    rel = _relL2(torch.from_numpy(out), torch.from_numpy(eager))
    print("[engine-flash] output vs the eager bf16 Calculator on the same clone: relative L2 %.3e (bound 1e-3); "
          "finite %s" % (rel, np.isfinite(out).all()))

    if out.shape != requests.shape or not np.isfinite(out).all() or not rel <= 1e-3:
        fail("flash engine output of shape %s, relative L2 %.3e from the eager run" % (out.shape, rel))

    return launches, (path, requests[:batch], out[:batch])


# [engine-driver]: each custom operator's nodes in each engine's program
# (the flash engine's matmul nodes are counted from its program), and the
# runs of the request in the driver and through Engine, the first of each
# set apart (the driver's is cold: CUDA's and the libraries' set-up; the
# Engine's follows a reload), the medians of the rest printed
DRIVER_NODES = {"int8": {"matmul_nt": 16}, "bf16": {"winograd_conv2d": 10, "matmul": 3}, "flash": {"flash": 1}}
DRIVER_OPERATORS = ("matmul", "matmul_nt", "winograd_conv2d", "flash")
DRIVER_RUNS = 11


def _programNodes(program):
    """Each custom operator's node count in an engine's program."""
    counts = dict.fromkeys(DRIVER_OPERATORS, 0)
    with open(program) as f:
        for line in f:
            fields = line.split()
            if fields[0] == "node" and fields[2].startswith("puzzlelib::"):
                counts[fields[2][len("puzzlelib::"):]] += 1
    return counts


def phaseEngineDriver(torch, card, driverJob, workdir, served):
    """[engine-driver]: the VGG-16 int8 and bf16 engines and the flash engine
    that [engine-int8], [engine-bf16] and [engine-flash] built, each run
    through the native driver (``converter/engine/src/engine_driver.cpp``)
    in a process of its own on that phase's first request: the output
    ``.npy`` bit-equal to ``Engine``'s output for that request in that
    phase, and each custom operator launched as many times a run as the
    program has nodes of it.  The driver's load and run times are printed
    beside ``Engine``'s for the same request on the card.  Returns each
    operator's launches in the driver's first runs."""
    import subprocess

    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.converter.engine import Engine

    started = time.perf_counter()
    driver, buildSecs = driverJob.result()
    print("[engine-driver] %s built in %.2f s beside [build]'s nvcc runs (waited %.2f s for it here)" %
          (os.path.basename(driver), buildSecs, time.perf_counter() - started))

    launches = dict.fromkeys(DRIVER_OPERATORS, 0)
    for label, (path, request, want) in served.items():
        program = path.replace(".engine", ".program")
        nodes = _programNodes(program)
        expected = dict(DRIVER_NODES[label])
        if label == "flash":
            expected["matmul"] = nodes["matmul"]
        if {op: n for op, n in nodes.items() if n} != {op: n for op, n in expected.items() if n}:
            fail("[engine-driver] the %s engine's program has custom operator nodes %s, expected %s" %
                 (label, nodes, expected))

        engine = Engine(path)
        x = torch.from_numpy(request).cuda()
        engineMs = []
        for _ in range(DRIVER_RUNS):
            synchronize()
            begin = time.perf_counter()
            engine(x)
            synchronize()
            engineMs.append(1e3 * (time.perf_counter() - begin))
        del engine, x

        inpath, outpath = os.path.join(workdir, label + ".in.npy"), os.path.join(workdir, label + ".out.npy")
        np.save(inpath, request)
        begin = time.perf_counter()
        proc = subprocess.run([str(driver), "--runs", str(DRIVER_RUNS), "cuda", program, outpath, inpath],
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - begin
        if proc.returncode != 0:
            fail("[engine-driver] the driver failed on the %s engine (exit %d):\n%s" %
                 (label, proc.returncode, proc.stderr[-3000:]))

        report = json.loads(next(line for line in proc.stderr.splitlines()
                                 if line.startswith("engine_driver: report "))[len("engine_driver: report "):])
        got = np.load(outpath)
        same = got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)

        print("[engine-driver] %s engine, request of %s: driver output bit-equal to Engine's: %s (max |diff| %.3e); "
              "launches a run %s, nodes %s" % (label, "x".join(map(str, request.shape)), "yes" if same else "NO",
                                               float(np.abs(got.astype(np.float64) - want).max()),
                                               report["launches"], nodes))
        print("[engine-driver] %s engine on %s: driver process %.3f s wall, program load %.3f ms, first run %.3f "
              "ms, median of the next %d %.3f ms; Engine in this process: first call %.3f ms, median of the next "
              "%d %.3f ms (driver / Engine %.3f)" %
              (label, card, wall, report["load_ms"], report["run_ms"][0], DRIVER_RUNS - 1,
               float(np.median(report["run_ms"][1:])), engineMs[0], DRIVER_RUNS - 1, float(np.median(engineMs[1:])),
               float(np.median(report["run_ms"][1:])) / float(np.median(engineMs[1:]))))
        print("[engine-driver] %s runs, ms: driver %s; Engine %s" %
              (label, " ".join("%.3f" % t for t in report["run_ms"]), " ".join("%.3f" % t for t in engineMs)))

        if not same:
            fail("[engine-driver] the driver's %s output differs from Engine's" % label)

        if report["launches"] != nodes or report["calls"] != nodes:
            fail("[engine-driver] the %s engine's driver run launched %s (calls %s), its program has %s nodes" %
                 (label, report["launches"], report["calls"], nodes))

        for op in DRIVER_OPERATORS:
            launches[op] += report["launches"][op]

    print("[time] [engine-driver] %.1f s" % (time.perf_counter() - started))
    return launches


# -- the fused step ----------------------------------------------------------------------------------------

def _counters():
    """Every launch counter a fused replay advances, by name."""
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

    return {"flash": (flash, "launches"), "flashWgmma": (flash, "launchesWgmma"), "flashDq": (flash, "launchesDq"),
            "flashDkv": (flash, "launchesDkv"), "matmul": (matmul, "launches"),
            "matmulWgmma": (matmul, "launchesWgmma"), "winograd": (winograd, "launches"),
            "winogradDataGrad": (winograd, "dataGradLaunches"), "winogradFG": (winograd, "filterGradLaunches")}


def _resetCounters():
    for holder, name in _counters().values():
        setattr(holder, name, 0)


def _readCounters():
    return {key: getattr(holder, name) for key, (holder, name) in _counters().items()}


def _profiledLaunches(tag, run, attempts=3):
    """Runs of ``run`` under the profiler, the counters reset just before
    each: fails unless, in one of ``attempts`` runs, the hand kernels'
    device events, by name, are exactly as many as the counters say.  The
    profiler has been seen to lose activity records (4 of a LeNet run's 16
    K1 events, once on an H100), never to invent them, so a run that shows
    fewer is run again, and every run is printed.  Returns (seconds, idle
    share) of the run that agreed."""
    from puzzlelib_tpu_torch.tools.profiletransformer import idleShare, kernelLaunches, profiled

    for attempt in range(1, attempts + 1):
        _resetCounters()
        secs, events = profiled(run)
        counts, seen = _readCounters(), kernelLaunches(events)
        want = {"K1": counts["matmul"], "K2": counts["winograd"], "K3": counts["winogradFG"], "K4": counts["flash"],
                "K5a": counts["flashDq"], "K5b": counts["flashDkv"]}

        print("[%s] profiled run %d: launches by the counters %s, device events by kernel name %s; %d device events, "
              "idle %.1f %%" % (tag, attempt, want, seen, len(events), 100.0 * idleShare(secs, events)))
        if seen == want:
            return secs, idleShare(secs, events)

    fail("[%s] in %d profiled runs the profiler's device events never matched the counters" % (tag, attempts))


def _checkViews(tag, torch, optimizer, variables, snapshot):
    """Fail unless every variable is still a view of the optimizer's flat
    buffers and changed from ``snapshot``."""
    packs = {dtype: (pack.ary.untyped_storage().data_ptr(), optimizer.shGrads[dtype].ary.untyped_storage()
                     .data_ptr()) for dtype, pack in optimizer.shParams.items()}
    for var, old in zip(variables, snapshot):
        if (var.data.untyped_storage().data_ptr(), var.grad.untyped_storage().data_ptr()) != packs[var.data.dtype]:
            fail("[%s] variable %s is no view of the optimizer's flat buffers" % (tag, var.name))

        if torch.equal(var.data, old):
            fail("[%s] variable %s did not change in training" % (tag, var.name))

    print("[%s] all %d variables are views of the flat buffers (%s) and changed" %
          (tag, len(variables), ", ".join(str(dtype) for dtype in packs)))


def _turns(runs, fns, count=5):
    """``count`` turns of each of ``fns`` (name -> callable returning
    seconds), in turns; their seconds appended to ``runs``."""
    for _ in range(count):
        for name, fn in fns.items():
            runs.setdefault(name, []).append(fn())
    return runs


def phaseFusedTransformerTrain(torch, card):
    """The transformer training slice through ``FusedTrainer`` (the fused
    step: a CUDA graph of the eager step, replayed), with
    ``stepsPerDispatch=4``, as ``testlib/transformertrain.py`` trains, and
    with ``stepsPerDispatch=1``.  The launches per step equal the eager
    route's, and the profiler's device events say the same; the losses
    with 1 step a dispatch within ``TRAIN_BOUND`` of the eager hand route's
    from the same start and batch order; a second fused run repeats bit for
    bit; every variable is a view of the flat buffers and changed; one
    recording per shape and none in steady state.  Then rows/s of the fused
    and eager hand routes over 16 steps in 5 runs in turns, and each one's
    idle share from one profiled run.  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config

    tag = "fused-transformer-train"
    config = Slice.CONFIG
    rows = Slice.STEPS * Slice.BATCH
    routes, allTokens, allLabels = Slice.buildTraining(rows=16 * Slice.BATCH)
    tokens, labels = allTokens[:rows], allLabels[:rows]
    hand, fused, single = routes["hopper"], routes["fused"], routes["fused-1"]

    for algo in ("hopper", "fused", "fused-1"):
        Slice.train(routes, algo, tokens, labels)
    captures = (fused.trainer.step.captures, single.trainer.step.captures)

    variables = list(hand.net.getVarTable())
    hand.restore()
    snapshot = [var.data.clone() for var in variables]

    _resetCounters()
    secs = Slice.train(routes, "fused", tokens, labels)
    launches = _readCounters()
    meanLoss = fused.trainer.cost.getMeanError()

    print("[%s] IMDB transformer bf16 (vocab %d, seq %d, emb %d, %d heads, %d layers), Adam, FusedTrainer(batchsize=%d, "
          "stepsPerDispatch=%d): %d rows in %d steps, %.4f s, %.1f rows/s on %s; mean loss %.6f" %
          (tag, config["vocabsize"], config["seqlen"], config["embsize"], config["nheads"], config["nlayers"],
           Slice.BATCH, Slice.STEPS_PER_DISPATCH, rows, Slice.STEPS, secs, rows / secs, card, meanLoss))
    print("[%s] launches in that run: flash forward %d (on wgmma %d), flash dq %d, flash dk/dv %d, matmul %d (on "
          "wgmma %d), winograd %d" % (tag, launches["flash"], launches["flashWgmma"], launches["flashDq"],
                                      launches["flashDkv"], launches["matmul"], launches["matmulWgmma"],
                                      launches["winograd"]))

    perLayer = config["nlayers"] * Slice.STEPS
    expected = {"flash": perLayer, "flashWgmma": perLayer, "flashDq": perLayer, "flashDkv": perLayer,
                "matmul": sum(count for *_, count in Slice.GEMMS) * Slice.STEPS,
                "matmulWgmma": _wgmmaGemms() * Slice.STEPS, "winograd": 0, "winogradDataGrad": 0, "winogradFG": 0}
    if launches != expected:
        fail("[%s] expected the eager route's launches %s, got %s" % (tag, expected, launches))

    if not np.isfinite(meanLoss):
        fail("[%s] mean loss %s" % (tag, meanLoss))

    _checkViews(tag, torch, hand.optimizer, variables, snapshot)
    del snapshot

    # one step a dispatch against the eager Trainer, same start and batch order
    eager, losses = [], []
    Slice.train(routes, "hopper", tokens, labels, eager)
    Slice.train(routes, "fused-1", tokens, labels, losses)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    print("[%s] stepsPerDispatch=1 step losses %s; eager Trainer %s; largest relative difference %.3e (bound %.0e); "
          "first step bit-equal: %s" % (tag, " ".join("%.6f" % loss for loss in losses),
                                        " ".join("%.6f" % loss for loss in eager), rel, TRAIN_BOUND,
                                        losses[0] == eager[0]))
    if len(losses) != Slice.STEPS or not rel <= TRAIN_BOUND:
        fail("[%s] fused step losses %s against eager %s" % (tag, losses, eager))

    embedGrad = _namedGrads(hand.net, ("embed.W", ))["embed.W"]
    again = []
    Slice.train(routes, "fused-1", tokens, labels, again)
    repeats = again == losses and torch.equal(_namedGrads(hand.net, ("embed.W", ))["embed.W"], embedGrad)
    print("[%s] a second fused run from the same start: losses %s; bit-equal to the first (losses and the last "
          "step's embed.W gradient): %s" % (tag, " ".join("%.6f" % loss for loss in again), repeats))
    if not repeats:
        fail("[%s] the fused run does not repeat: losses %s, then %s" % (tag, losses, again))

    # the speed of 16 steps of 64, fused and eager, in turns; then one
    # profiled run of each, its device events held to the counters
    runs = _turns({}, {"fused": lambda: Slice.train(routes, "fused", allTokens, allLabels),
                       "hopper": lambda: Slice.train(routes, "hopper", allTokens, allLabels)})
    _, fusedIdle = _profiledLaunches(tag, lambda: Slice.train(routes, "fused", allTokens, allLabels))
    _, eagerIdle = _profiledLaunches(tag, lambda: Slice.train(routes, "hopper", allTokens, allLabels))
    Config.gemmAlgo = "hopper"

    after = (fused.trainer.step.captures, single.trainer.step.captures)
    print("[%s] recordings (CUDA graph captures): stepsPerDispatch=%d %d, stepsPerDispatch=1 %d after the warm-up, "
          "%s after every later run" % (tag, Slice.STEPS_PER_DISPATCH, captures[0], captures[1], after))
    if captures != (1, 1) or after != captures:
        fail("[%s] expected one recording per step and none in steady state, got %s then %s" % (tag, captures, after))

    for algo, label, idle in (("fused", "fused (FusedTrainer, %d steps a dispatch)" % Slice.STEPS_PER_DISPATCH,
                               fusedIdle), ("hopper", "eager hand route (Trainer)", eagerIdle)):
        print("[%s] %s, %d rows in %d steps, 5 runs in turns: %s s, median %.1f rows/s; idle %.1f %% of one profiled "
              "run, on %s" % (tag, label, len(allTokens), len(allTokens) // Slice.BATCH,
                              " ".join("%.4f" % t for t in runs[algo]), len(allTokens) / float(np.median(runs[algo])),
                              100.0 * idle, card))

    return launches


def phaseFusedTransformerServe(torch, card):
    """The transformer serving slice through ``FusedCalculator(batchsize=
    64)``: 4 requests of 64 rows with the counters reset just before and
    read just after (K4 and K1 as [transformer] counts them, and as many
    device events by name under the profiler), the logits within
    ``SLICE_BOUND`` of the eager hand route's; rows/s fused and eager in 5
    runs in turns and each one's idle share.  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config

    tag = "fused-transformer-serve"
    config = Slice.CONFIG
    routes, tokens = Slice.build()
    for net in routes.values():
        net.calcMode(torch.bfloat16)
    routes[Slice.FUSED] = Slice.fusedCalculator(routes)

    for algo in ("hopper", Slice.FUSED):
        Slice.serve(routes, algo, tokens)
    captures = routes[Slice.FUSED]._program.captures

    _resetCounters()
    out, secs = Slice.serve(routes, Slice.FUSED, tokens)
    launches = _readCounters()

    print("[%s] IMDB transformer bf16, FusedCalculator(batchsize=%d): %d rows in %d requests, %.4f s, %.1f rows/s on "
          "%s" % (tag, Slice.BATCH, len(tokens), Slice.REQUESTS, secs, len(tokens) / secs, card))
    print("[%s] launches in that run: flash %d (on wgmma %d), matmul %d (on wgmma %d), winograd %d" %
          (tag, launches["flash"], launches["flashWgmma"], launches["matmul"], launches["matmulWgmma"],
           launches["winograd"]))

    expected = {"flash": config["nlayers"] * Slice.REQUESTS, "flashWgmma": config["nlayers"] * Slice.REQUESTS,
                "flashDq": 0, "flashDkv": 0, "matmul": sum(count for *_, count in Slice.GEMMS) * Slice.REQUESTS,
                "matmulWgmma": _wgmmaGemms() * Slice.REQUESTS, "winograd": 0, "winogradDataGrad": 0, "winogradFG": 0}
    if launches != expected:
        fail("[%s] expected the eager route's launches %s, got %s" % (tag, expected, launches))

    eager, _ = Slice.serve(routes, "hopper", tokens)
    rel = _relL2(torch.from_numpy(out), torch.from_numpy(eager))
    print("[%s] logits against the eager hand route's: relative L2 %.3e (bound %.0e), largest difference %.3e, "
          "bit-equal %s" % (tag, rel, SLICE_BOUND, np.abs(out - eager).max(), np.array_equal(out, eager)))
    if out.shape != eager.shape or not np.isfinite(out).all() or not rel <= SLICE_BOUND:
        fail("[%s] logits of shape %s differ from the eager route's by %.3e" % (tag, out.shape, rel))

    runs = _turns({}, {"fused": lambda: Slice.serve(routes, Slice.FUSED, tokens)[1],
                       "hopper": lambda: Slice.serve(routes, "hopper", tokens)[1]})
    _, fusedIdle = _profiledLaunches(tag, lambda: Slice.serve(routes, Slice.FUSED, tokens)[1])
    _, eagerIdle = _profiledLaunches(tag, lambda: Slice.serve(routes, "hopper", tokens)[1])
    Config.gemmAlgo = "hopper"

    after = routes[Slice.FUSED]._program.captures
    print("[%s] recordings: %d after the warm-up, %d after every later run" % (tag, captures, after))
    if captures != 1 or after != 1:
        fail("[%s] expected one recording and none in steady state, got %d then %d" % (tag, captures, after))

    for algo, label, idle in (("fused", "fused (FusedCalculator)", fusedIdle),
                              ("hopper", "eager hand route (Calculator)", eagerIdle)):
        print("[%s] %s, 5 runs in turns: %s s, median %.1f rows/s; idle %.1f %% of one profiled run, on %s" %
              (tag, label, " ".join("%.4f" % t for t in runs[algo]), len(tokens) / float(np.median(runs[algo])),
               100.0 * idle, card))

    return launches


def _fusedCnnTurns(tag, run, images, labels, card, valImages=None, valLabels=None):
    """5 runs of the fused and the eager hand route in turns (training, and
    validation where images are given): the median images/s printed."""
    fns = {"fused train": lambda: run.train("fused", images, labels),
           "hopper train": lambda: run.train("hopper", images, labels)}
    if valImages is not None:
        fns.update({"fused validate": lambda: run.validate("fused", valImages, valLabels)[1],
                    "hopper validate": lambda: run.validate("hopper", valImages, valLabels)[1]})

    runs = _turns({}, fns)
    for name, secs in runs.items():
        count = len(images) if name.endswith("train") else len(valImages)
        print("[%s] %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
              (tag, name.replace("hopper", "eager hand route,").replace("fused", "fused route,"),
               " ".join("%.4f" % t for t in secs), count / float(np.median(secs)), card))


def phaseFusedCnn(torch, card):
    """The CNN slices of ``tools/cnnslice.py`` through ``FusedTrainer`` and
    ``FusedValidator`` at [lenet]'s, [nin-cifar]'s and [nin]'s batch and step
    counts.  LeNet f32: K1 replayed as eager counts it, losses within 1e-4 of
    the eager hand route's, equal validation errors.  The CIFAR-10 NIN f32
    with dropout and ``WeightDecay``: with the learning and momentum rates
    set to 0 between calls (no new recording), three steps on one batch
    leave the weights as they were and give three different losses
    (different dropout masks), and repeat them bit for bit from the same
    seed; the rates set back, the weights move, still with no new
    recording; equal validation errors.  The ImageNet NiN bf16: K2, K2-bwd
    and K3 replayed, one each a step on each of conv3 and conv4-1024
    (counted inside each layer), losses within 5e-2 of the eager route's.
    Images/s fused and eager in 5 runs in turns.  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch import fused as Fused
    from puzzlelib_tpu_torch.ops.hopper import winograd

    Config.device = "cuda"
    launches = {}

    # LeNet
    tag = "fused-cnn"
    images, labels = Cnn.data("lenet", Cnn.BATCH * Cnn.STEPS)
    valImages, valLabels = Cnn.data("lenet", Cnn.VALIDATION, seed=2)
    run = Cnn.buildRun("lenet")
    for algo in ("hopper", "fused"):
        run.train(algo, images, labels)
        run.validate(algo, valImages, valLabels)

    losses, eager = [], []
    _resetCounters()
    run.train("fused", images, labels, losses)
    launches["lenet"] = _readCounters()["matmul"]
    _resetCounters()
    error, _ = run.validate("fused", valImages, valLabels)
    launches["lenetValidate"] = _readCounters()["matmul"]
    run.train("hopper", images, labels, eager)
    eagerError, _ = run.validate("hopper", valImages, valLabels)

    print("[%s] LeNet f32 through FusedTrainer / FusedValidator: K1 launches %d in %d steps, %d in the validation of "
          "%d (eager: %d, %d); recordings %d + %d" %
          (tag, launches["lenet"], Cnn.STEPS, launches["lenetValidate"], Cnn.VALIDATION, 2 * Cnn.STEPS,
           2 * Cnn.VALIDATION // Cnn.BATCH, run.fusedTrainer.step.captures, run.fusedValidator._program.captures))
    if (launches["lenet"], launches["lenetValidate"]) != (2 * Cnn.STEPS, 2 * Cnn.VALIDATION // Cnn.BATCH):
        fail("[%s] LeNet: K1 launches %s" % (tag, launches))

    _lossesAgainst(tag, losses, eager, CNN_LOSS_BOUND, ref="LeNet, eager hand route")
    _profiledLaunches(tag, lambda: run.train("fused", images, labels))
    print("[%s] LeNet validation error: fused %r, eager %r" % (tag, error, eagerError))
    if error != eagerError:
        fail("[%s] LeNet validation errors differ: %r against %r" % (tag, error, eagerError))

    _fusedCnnTurns(tag + "] [lenet", run, images, labels, card, valImages, valLabels)
    del run

    # the CIFAR-10 NIN: dropout under replay, a rate changed between calls
    images, labels = Cnn.data("nin-cifar", Cnn.BATCH * Cnn.STEPS)
    valImages, valLabels = Cnn.data("nin-cifar", Cnn.VALIDATION, seed=2)
    run = Cnn.buildRun("nin-cifar")
    for algo in ("hopper", "fused"):
        run.train(algo, images, labels)
        run.validate(algo, valImages, valLabels)

    losses, eager = [], []
    run.train("fused", images, labels, losses)
    run.train("hopper", images, labels, eager)
    print("[%s] CIFAR-10 NIN f32 step losses: fused %s; eager %s; the draws of a replay equal the eager step's from "
          "the same generator state (first-step losses bit-equal): %s" %
          (tag, " ".join("%.6f" % x for x in losses), " ".join("%.6f" % x for x in eager), losses[0] == eager[0]))

    step, optimizer = run.fusedTrainer.step, run.optimizer
    captures = step.captures
    x = torch.from_numpy(images[:Cnn.BATCH]).cuda()
    y = torch.from_numpy(labels[:Cnn.BATCH]).cuda()

    def still():
        run.restore()
        optimizer.learnRate = optimizer.momRate = 0.0
        stepped = []
        for _ in range(3):
            step(x, y)
            stepped.append(step.cost.getError())
        return stepped

    first, second = still(), still()
    unchanged = all(torch.equal(pack.ary, run.start[dtype]) for dtype, pack in optimizer.shParams.items())
    optimizer.learnRate, optimizer.momRate = Cnn.LEARN_RATE, Cnn.MOM_RATE
    step(x, y)
    moved = not any(torch.equal(pack.ary, run.start[dtype]) for dtype, pack in optimizer.shParams.items())

    print("[%s] CIFAR-10 NIN, one batch three times at learning and momentum rate 0: losses %s, again from the same "
          "seed %s; weights unchanged %s; rates set back: weights moved %s; recordings %d before, %d after" %
          (tag, " ".join("%.6f" % v for v in first), " ".join("%.6f" % v for v in second), unchanged, moved,
           captures, step.captures))
    if len(set(first)) != 3 or first != second or not unchanged or not moved or step.captures != captures:
        fail("[%s] dropout under replay or the rate change: losses %s / %s, unchanged %s, moved %s, recordings %d "
             "-> %d" % (tag, first, second, unchanged, moved, captures, step.captures))

    error, _ = run.validate("fused", valImages, valLabels)
    eagerError, _ = run.validate("hopper", valImages, valLabels)
    print("[%s] CIFAR-10 NIN validation error: fused %r, eager %r" % (tag, error, eagerError))
    if error != eagerError:
        fail("[%s] CIFAR-10 NIN validation errors differ: %r against %r" % (tag, error, eagerError))

    _fusedCnnTurns(tag + "] [nin-cifar", run, images, labels, card, valImages, valLabels)
    del run, x, y
    torch.cuda.empty_cache()

    # the ImageNet NiN
    convs = [name for name, _, _ in Cnn.NIN_KERNEL_CONVS]
    images, labels = Cnn.data("nin", Cnn.BATCH * REQUESTS)
    run = Cnn.buildRun("nin")
    counter = _LayerLaunches(winograd, run.net, convs)
    Fused.COUNTERS.extend(counter.replayed())

    try:
        for algo in ("hopper", "fused"):
            run.train(algo, images, labels)

        losses, eager = [], []
        counter.reset()
        _resetCounters()
        run.train("fused", images, labels, losses)
        counts = _readCounters()
        launches["nin"] = {key: counts[key] for key in ("winograd", "winogradDataGrad", "winogradFG")}
        print("[%s] ImageNet NiN bf16 through FusedTrainer, %d steps of %d: winograd %d (forward %d, bwd-data %d), "
              "winogradFG %d; recordings %d" %
              (tag, REQUESTS, Cnn.BATCH, counts["winograd"], counts["winograd"] - counts["winogradDataGrad"],
               counts["winogradDataGrad"], counts["winogradFG"], run.fusedTrainer.step.captures))
        counter.check(tag, (REQUESTS, REQUESTS, REQUESTS))

        want = {"winograd": 4 * REQUESTS, "winogradDataGrad": 2 * REQUESTS, "winogradFG": 2 * REQUESTS}
        if launches["nin"] != want:
            fail("[%s] ImageNet NiN: expected launches %s, got %s" % (tag, want, launches["nin"]))

        run.train("hopper", images, labels, eager)
        _lossesAgainst(tag, losses, eager, TRAIN_BOUND, ref="ImageNet NiN, eager hand route")
        _profiledLaunches(tag, lambda: run.train("fused", images, labels))
        _fusedCnnTurns(tag + "] [nin", run, images, labels, card)

    finally:
        for entry in counter.replayed():
            Fused.COUNTERS.remove(entry)

    Config.gemmAlgo = Config.convAlgo = "hopper"
    del run
    torch.cuda.empty_cache()
    return launches


def _stats(stats, refStats):
    """(means, variances) of the batch norms' running stats against
    ``refStats``: the running variances as one vector in relative L2, the
    running means as the RMS over every map of their difference in units of
    the map's running standard deviation (``refStats``'s), the shift that
    the difference makes in an eval-mode output.  A running mean sits near
    zero against its spread, so its plain relative L2 measures the spread of
    the batches more than the agreement of the two runs."""
    names = sorted(name[:-len(".mean")] for name in refStats if name.endswith(".mean"))
    mean, refMean, var, refVar = (np.concatenate([table[name + suffix].ravel() for name in names])
                                  for table, suffix in ((stats, ".mean"), (refStats, ".mean"), (stats, ".var"),
                                                        (refStats, ".var")))

    shift = float(np.sqrt(np.mean(((mean - refMean) / np.sqrt(refVar)) ** 2)))
    return shift, float(np.linalg.norm(var - refVar) / np.linalg.norm(refVar))


def _statsAgainst(tag, stats, refStats, ref, meanBound=TRAIN_BOUND, varBound=TRAIN_BOUND):
    """Fail unless the batch norms' running stats are within the bounds of
    ``ref``'s (``_stats``)."""
    shift, varRel = _stats(stats, refStats)
    print("[%s] running stats of the %d batch norms against the %s's: means %.3e (RMS of the difference over the "
          "running std; bound %.3e), variances %.3e relative L2 (bound %.3e)" %
          (tag, sum(name.endswith(".mean") for name in refStats), ref, shift, meanBound, varRel, varBound))

    if not (shift <= meanBound and varRel <= varBound):
        fail("[%s] running stats differ from the %s's: means %.3e, variances %.3e" % (tag, ref, shift, varRel))


def _resnetGradsAgainst(tag, backward, convs):
    """Fail unless the gradient of every variable from the backward on the
    hand kernels is within TRAIN_BOUND of the library's, or no farther from
    it than the farthest of the library's own backwards from the loss
    gradient one bf16 ulp apart (``_backwardGrads``'s seeds); prints the
    readings of the Winograd convs ``convs`` and of the variables past
    TRAIN_BOUND."""
    seeds = [key for key in backward if key not in ("hopper", "torch")]
    ref = backward["torch"]
    readings = {name: (_relL2(backward["hopper"][name], ref[name]),
                       max(_relL2(backward[seed][name], ref[name]) for seed in seeds)) for name in ref}

    for name, (rel, control) in readings.items():
        if name.split(".")[-2] in convs or rel > TRAIN_BOUND:
            print("[%s] first-step gradient of %s: backward on the hand kernels vs the library's, same forward: "
                  "relative L2 %.3e; the library's from the loss gradient one ulp apart %.3e (bound %.3e)" %
                  (tag, name, rel, control, max(TRAIN_BOUND, control)))

    worst = max(readings, key=lambda name: readings[name][0])
    print("[%s] first-step gradients of all %d variables: largest %.3e (%s), median %.3e; the controls' median %.3e" %
          (tag, len(readings), readings[worst][0], worst, float(np.median([r for r, _ in readings.values()])),
           float(np.median([c for _, c in readings.values()]))))

    for name, (rel, control) in readings.items():
        if not rel <= max(TRAIN_BOUND, control):
            fail("[%s] first-step gradient of %s on the hand kernels differs from the library's by %.3e (control "
                 "%.3e)" % (tag, name, rel, control))


class _SliceLaunches:
    """A slice phase's launch counts.  ``counted(fn)`` runs ``fn`` with every
    counter at 0 and returns (its result, the K2, K2 bwd-data, K3 and K1
    counts); ``expect`` fails unless those are ``steps`` batches through
    each of the Winograd convs ``convs`` (counted inside each conv too) and
    ``gemms`` K1 a batch, on wgmma.  Inside ``with``, the per-conv counts sit
    in ``fused.COUNTERS``, so that a fused replay adds to them."""

    KEYS = ("winograd", "winogradDataGrad", "winogradFG", "matmul", "matmulWgmma")

    def __init__(self, tag, winograd, net, convs, gemms):
        self.tag, self.nconvs, self.gemms = tag, len(convs), gemms
        self.layers = _LayerLaunches(winograd, net, convs)

    def __enter__(self):
        self.layers.__enter__()
        return self

    def __exit__(self, *exc):
        self.layers.__exit__(*exc)

    def counted(self, fn):
        self.layers.reset()
        _resetCounters()
        result = fn()
        counts = _readCounters()
        return result, {key: counts[key] for key in self.KEYS}

    def expect(self, what, counts, steps, backward):
        forward = self.nconvs * steps
        want = {"winograd": forward * (1 + backward), "winogradDataGrad": forward * backward,
                "winogradFG": forward * backward, "matmul": self.gemms * steps, "matmulWgmma": self.gemms * steps}
        print("[%s] %s launches: K2 %d (forward %d, bwd-data %d), K3 %d, K1 %d (on wgmma %d)" %
              (self.tag, what, counts["winograd"], counts["winograd"] - counts["winogradDataGrad"],
               counts["winogradDataGrad"], counts["winogradFG"], counts["matmul"], counts["matmulWgmma"]))
        self.layers.check(self.tag, (steps, steps * backward, steps * backward))
        if counts != want:
            fail("[%s] %s: expected launches %s, got %s" % (self.tag, what, want, counts))


def _sameBitsAgain(tag, torch, run, algo, images, labels, losses, what):
    """Train ``algo`` once more from the same start; fail unless its losses
    are ``losses`` and the weights those the run before left, bit for
    bit."""
    weights = [(var.data, var.data.clone()) for var in run.net.getVarTable()]
    again = []
    run.train(algo, images, labels, again)
    same = again == losses and all(torch.equal(data, ary) for data, ary in weights)
    print("[%s] %s again from the same start: losses and weights bit-equal %s" % (tag, what, same))
    if not same:
        fail("[%s] a second run of the %s gave other bits" % (tag, what))


def _fusedAgainstEager(tag, torch, run, counter, launches, images, labels, losses, valImages, valLabels,
                       bound=TRAIN_BOUND):
    """The steps of ``images`` through ``FusedTrainer`` against the eager
    hand route's ``losses``: the same launches replayed (``counter``, into
    ``launches["fused"]``), the first loss bit-equal (a replayed dropout
    draws what the eager step draws), the rest within ``bound``, one
    recording, a second run the same bits; then ``FusedValidator`` equal to
    ``Validator`` on the fused weights."""
    steps = len(losses)
    run.train("fused", images, labels)
    fusedLosses = []
    _, launches["fused"] = counter.counted(lambda: run.train("fused", images, labels, fusedLosses))
    counter.expect("FusedTrainer, %d steps of %d" % (steps, len(images) // steps), launches["fused"], steps, 1)
    print("[%s] first-step loss fused %r, eager %r: bit-equal %s; recordings %d" %
          (tag, fusedLosses[0], losses[0], fusedLosses[0] == losses[0], run.fusedTrainer.step.captures))
    if fusedLosses[0] != losses[0] or run.fusedTrainer.step.captures != 1:
        fail("[%s] fused first-step loss %r against %r, recordings %d" %
             (tag, fusedLosses[0], losses[0], run.fusedTrainer.step.captures))

    _lossesAgainst(tag, fusedLosses, losses, bound, ref="eager hand route")
    _sameBitsAgain(tag, torch, run, "fused", images, labels, fusedLosses, "FusedTrainer")

    error, _ = run.validate("fused", valImages, valLabels)
    eagerError, _ = run.validate("hopper", valImages, valLabels)
    print("[%s] validation error of %d images: fused %r, eager %r; recordings %d" %
          (tag, len(valImages), error, eagerError, run.fusedValidator._program.captures))
    if error != eagerError:
        fail("[%s] validation errors differ: %r against %r" % (tag, error, eagerError))


def _routeRates(tag, card, work, unit="images"):
    """``unit``/s of each of SLICE_ROUTES on each of ``work`` (what ->
    (count, fn(algo) returning seconds)), 5 runs in turns."""
    fns = {"%s %s" % (algo, what): (lambda algo=algo, fn=fn: fn(algo)) for algo in SLICE_ROUTES
           for what, (_, fn) in work.items()}

    for name, secs in _turns({}, fns).items():
        algo, what = name.split()
        print("[%s] %s, %s, 5 runs in turns: %s s, median %.2f %s/s on %s" %
              (tag, SLICE_ROUTES[algo], what, " ".join("%.4f" % t for t in secs),
               work[what][0] / float(np.median(secs)), unit, card))


def _idleShares(tag, run, images, labels):
    """The idle share of the card in a profiled training run of ``images``
    on the fused and the eager hand route, the launches held to the
    profiler's device events (``_profiledLaunches``)."""
    idle = {algo: _profiledLaunches(tag, lambda algo=algo: run.train(algo, images, labels))[1]
            for algo in ("fused", "hopper")}
    print("[%s] idle share of the card, %d training images under the profiler: fused %.1f %%, eager hand route "
          "%.1f %%" % (tag, len(images), 100 * idle["fused"], 100 * idle["hopper"]))


def phaseResNet50(torch, card):
    """ResNet-50 in bf16 at batch 32 (``tools/resnetslice.py``), He weights
    from ``np.random.seed(0)``, without its SoftMax, ``MomentumSGD(0.01,
    0.9)`` in global state.  Serving: 4 requests through ``Calculator`` on
    the hand route and the library route, in turns; one K2 a request on
    each of the convs ``winograd.applicable`` takes (counted from the net,
    inside each conv) and one K1 (fc1000); the logits within 5e-2 of the
    library route's.  Training: the backward of one forward on the hand
    kernels and on the library, every variable's gradient within 5e-2 or
    no farther than the library's own backward from the loss gradient one
    bf16 ulp apart (``_resnetGradsAgainst``); one step on both routes from
    the same weights, the running stats (that batch's) within 5e-2 of the
    library route's; then 12 steps (the batch norms' factor meets its 0.1
    floor at the tenth) on both routes; one K2, K2-bwd and K3 a step on
    each of those convs and one K1; the losses within 5e-2 of the library
    route's, the running stats within 5e-2 or no farther than the library
    route's own 12 steps from the input one bf16 ulp apart
    (``RESNET_INPUT_CONTROLS``: the routes' weights part in 12 steps, and
    rounding alone carries the running means past 5e-2).  Fused: the same
    12 steps through ``FusedTrainer``, the same launches replayed; the
    first loss bit-equal to the eager hand route's, the rest and the
    running stats within 5e-2; one recording; a second fused run the same
    bits; ``FusedValidator`` equal to ``Validator``; a ``FusedCalculator`` replay after more eager training
    equal to the eager ``Calculator`` on the new weights and running stats,
    with no new recording.  Then images/s of each route (5 runs in turns), the idle
    share of the fused and the eager hand route under the profiler (whose
    device events must count what the counters count), ``netspeed --net
    resnet50 --dtype bfloat16`` training and ``--infer``, and K2, K2-bwd
    and K3 at ResNet-50's three Winograd shapes, and K1 at fc1000.
    Returns the launches and the kernels' numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.benchmarks import netspeed
    from puzzlelib_tpu_torch.convert import attrsToNumpy
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    tag = "resnet50"
    run = Res.buildRun()
    net = run.net
    convs = Res.winogradConvs(net, (Res.BATCH, ) + Res.SHAPE)
    print("[%s] ResNet-50 bf16 at batch %d, %d convs, of which K2 / K3 take %d: %s" %
          (tag, Res.BATCH, len(Res.convInputs(net, (Res.BATCH, ) + Res.SHAPE)), len(convs), " ".join(convs)))

    images, labels = Res.data(Res.BATCH * Res.STEPS)
    requests = images[:Res.BATCH * REQUESTS]
    valImages, valLabels = Res.data(Res.BATCH * REQUESTS, seed=2)

    launches = {}
    with _SliceLaunches(tag, winograd, net, convs, 1) as counter:
        # eager serving, hand and library routes
        for algo in ("torch", "hopper"):
            run.serve(algo, requests)

        (out, secs), launches["serving"] = counter.counted(lambda: run.serve("hopper", requests))
        counter.expect("serving, %d requests of %d" % (REQUESTS, Res.BATCH), launches["serving"], REQUESTS, 0)
        libOut, _ = run.serve("torch", requests)

        if out.shape != (len(requests), Res.CLASSES) or not np.isfinite(out).all():
            fail("[%s] logits of shape %s, finite: %s" % (tag, out.shape, np.isfinite(out).all()))

        rel = float(np.linalg.norm(out - libOut) / np.linalg.norm(libOut))
        print("[%s] serving %d images: %.4f s; logits against the library route's: relative L2 %.3e (bound %.0e)" %
              (tag, len(requests), secs, rel, SLICE_BOUND))
        if not rel <= SLICE_BOUND:
            fail("[%s] logits differ from the library route's by %.3e" % (tag, rel))

        # the backward of one forward on the hand kernels against the
        # library's, every variable, beside the library's own backward from
        # the loss gradient one bf16 ulp apart
        run.restore()
        backward = _backwardGrads(torch, Config, run.trainer, net, images, labels, names=None, batch=Res.BATCH,
                                  seeds=RESNET_GRAD_SEEDS)
        _resnetGradsAgainst(tag, backward, convs)

        # eager training, hand and library routes; first one step from the
        # same weights, whose running stats are that batch's (the factor is
        # 1): the forward's agreement through every batch norm
        oneStep = {}
        for algo in ("torch", "hopper"):
            run.train(algo, images[:Res.BATCH], labels[:Res.BATCH])
            oneStep[algo] = attrsToNumpy(net)
        _statsAgainst(tag + "] [one step", oneStep["hopper"], oneStep["torch"], "library route")

        for algo in ("torch", "hopper"):
            run.train(algo, images, labels)

        losses, libLosses = [], []
        secs, launches["training"] = counter.counted(lambda: run.train("hopper", images, labels, losses))
        counter.expect("training, %d steps of %d" % (Res.STEPS, Res.BATCH), launches["training"], Res.STEPS, 1)
        print("[%s] training, MomentumSGD(%g, %g): %d images in %d steps, %.4f s" %
              (tag, Res.LEARN_RATE, Res.MOM_RATE, len(images), Res.STEPS, secs))
        stats = attrsToNumpy(net)

        run.train("torch", images, labels, libLosses)
        libStats = attrsToNumpy(net)
        _lossesAgainst(tag, losses, libLosses, TRAIN_BOUND)

        # after 12 steps the routes' weights have parted: the running stats
        # are held to how far the library route parts from itself when its
        # input moves by one bf16 ulp
        meanBound, varBound = TRAIN_BOUND, TRAIN_BOUND
        for every, seed in RESNET_INPUT_CONTROLS:
            moved = _ulpApart(torch, torch.from_numpy(images).to("cuda", torch.bfloat16), seed, 1 / every)
            moved = moved.float().cpu().numpy()
            run.train("torch", moved[:Res.BATCH], labels[:Res.BATCH])
            one = _stats(attrsToNumpy(net), oneStep["torch"])
            controlLosses = []
            run.train("torch", moved, labels, controlLosses)
            twelve = _stats(attrsToNumpy(net), libStats)
            lossRel = max(abs(a - b) / abs(b) for a, b in zip(controlLosses, libLosses))
            print("[%s] control, the library route from the input one bf16 ulp apart (%s, seed %d): one step: means "
                  "%.3e, variances %.3e; %d steps: losses %.3e, means %.3e, variances %.3e" %
                  (tag, "every pixel" if every == 1 else "one pixel in %d" % every, seed, one[0], one[1], Res.STEPS,
                   lossRel, twelve[0], twelve[1]))
            meanBound, varBound = max(meanBound, twelve[0]), max(varBound, twelve[1])

        _statsAgainst(tag, stats, libStats, "library route", meanBound, varBound)

        # the fused forms
        _fusedAgainstEager(tag, torch, run, counter, launches, images, labels, losses, valImages, valLabels)
        _statsAgainst(tag, attrsToNumpy(net), stats, "eager hand route")

        run.serve("fused", requests)
        (before, _), launches["fusedServing"] = counter.counted(lambda: run.serve("fused", requests))
        counter.expect("FusedCalculator, %d requests of %d" % (REQUESTS, Res.BATCH), launches["fusedServing"],
                       REQUESTS, 0)
        Config.gemmAlgo = Config.convAlgo = "hopper"
        run.trainer.trainFromHost(images[:2 * Res.BATCH], labels[:2 * Res.BATCH])
        after, _ = run.serve("fused", requests)
        eagerAfter, _ = run.serve("hopper", requests)
        moved = float(np.linalg.norm(after - before) / np.linalg.norm(before))
        print("[%s] FusedCalculator after 2 more eager steps: equal to the eager Calculator %s; moved %.3e "
              "relative L2 from its replay before them; recordings %d" %
              (tag, np.array_equal(after, eagerAfter), moved, run.fusedCalculator._program.captures))
        if not np.array_equal(after, eagerAfter) or moved == 0.0 or run.fusedCalculator._program.captures != 1:
            fail("[%s] the FusedCalculator replay does not read the new weights and running stats" % tag)

        # rates and idle shares
        _routeRates(tag, card, {"training": (len(images), lambda algo: run.train(algo, images, labels)),
                                "serving": (len(requests), lambda algo: run.serve(algo, requests)[1])})
        _idleShares(tag, run, images[:2 * Res.BATCH], labels[:2 * Res.BATCH])

    Config.gemmAlgo = Config.convAlgo = "hopper"
    del run, net
    torch.cuda.empty_cache()

    for extra in (["--infer"], ["--profile"]):
        result = netspeed.main(["--net", "resnet50", "--dtype", "bfloat16", "--iters", "5"] + extra)
        print("[%s] netspeed %s: %.2f ms a step, %.1f images/s on %s" %
              (tag, result["mode"], result["secs"] * 1e3, result["batch"] / result["secs"], card))
    torch.cuda.empty_cache()

    kernels = _convKernels(torch, winograd, tag, Res.KERNEL_CONVS, Res.BATCH)
    gemm = _gemmCase(torch, matmul, torch.Generator(device="cuda").manual_seed(5), "fc1000", "bf16", Res.BATCH,
                     2048, Res.CLASSES)
    kernels["K1"] = {"max_abs_err": gemm["abs_err"], "ms": gemm["ms"], "plain_ms": gemm["plain_ms"],
                     "bound_ms": gemm["bound_ms"], "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"]}
    return launches, kernels


# -- U-Net and Inception ----------------------------------------------------------------------------------

def phaseUNet(torch, card):
    """U-Net in bf16 at batch 4 on 1 x 512 x 512 inputs
    (``tools/unetslice.py``), He weights from ``np.random.seed(0)``.
    Serving: 4 requests through ``Calculator`` with the sigmoid, the first
    request's logits and sigmoid outputs each within 5e-2 relative L2 of
    the same f32 weights on the library route.  Training without the
    sigmoid, ``BCE`` and ``MomentumSGD(LEARN_RATE, 0.99)`` in global state:
    the backward of one forward on the hand kernels, every variable's
    gradient within 5e-2 or no farther than the library's own backward from
    the loss gradient one bf16 ulp apart (``_resnetGradsAgainst``); 8 steps
    on the hand and the library routes, the losses within 5e-2 of the
    library's and on neither route growing from a step to the next; the
    hand route twice, the same bits.  Validation of 16 images with ``BCE``
    (the share of pixels whose logit's sign misses the mask) on the weights
    the library route trained: the hand route's error no farther from the
    library route's than the library route's own from those weights in f32
    (``_f32Validation``) or from the input one bf16 ulp apart.  Fused: the
    same 8 steps through ``FusedTrainer`` (``_fusedAgainstEager``: its
    dropout replayed, the first loss bit-equal to the eager one's, the rest
    within 5e-2, twice the same bits, one recording); ``FusedValidator``
    equal to ``Validator``; ``FusedCalculator`` within 5e-2 of
    ``Calculator``.  Launches, counted from the net (``winogradConvs``) and
    inside each conv: one K2 a request or validated batch and one K2, K2-bwd
    and K3 a step on each of its 15 Winograd convs, and no K1; the fused
    ones also by the profiler.  Then images/s of each route (5 runs in
    turns), the idle share of 2 profiled steps, the peak of device memory,
    and K2, K2-bwd and K3 at each of the 15 convs against channels-last
    cuDNN.  Returns the launches and the kernels' numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.modules import Dropout
    from puzzlelib_tpu_torch.ops.hopper import winograd
    from puzzlelib_tpu_torch.tools import unetslice as Unet

    Config.device = "cuda"
    Config.globalEvalMode = False
    tag = "unet"
    torch.cuda.reset_peak_memory_stats()

    net = Unet.build()
    images, masks = Unet.data(Unet.BATCH * Unet.STEPS)
    requests = images[:Unet.BATCH * REQUESTS]
    valImages, valMasks = Unet.data(Unet.BATCH * REQUESTS, seed=2)
    first = torch.from_numpy(requests[:Unet.BATCH]).cuda()

    # the f32 reference of serving: the same weights on the library route
    # (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    refOut = net(first).float().clone()
    refLogits = net.graph[-2].data.float().clone()
    net.reset()

    run = Unet.buildRun(net)
    convs = Res.winogradConvs(net, (Unet.BATCH, ) + Unet.SHAPE)
    drops = ["%s (p %g)" % (mod.name, mod.p) for mod in net.getAllByType(Dropout)]
    print("[%s] U-Net bf16 at batch %d on %s inputs, %d parameters, %d convs, of which K2 / K3 take %d: %s; "
          "dropouts %s; MomentumSGD(%g, %g), BCE" %
          (tag, Unet.BATCH, "x".join(map(str, Unet.SHAPE)), net.numOfParams(),
           len(Res.convInputs(net, (Unet.BATCH, ) + Unet.SHAPE)), len(convs), " ".join(convs), ", ".join(drops),
           Unet.LEARN_RATE, Unet.MOM_RATE))
    if len(drops) != 2:
        fail("[%s] expected U-Net's two dropouts, found %s" % (tag, drops))

    launches = {}
    with _SliceLaunches(tag, winograd, net, convs, 0) as counter:
        # serving, with the sigmoid: the logits and the sigmoid's outputs
        # against the f32 reference
        for algo in ("torch", "hopper"):
            run.serve(algo, requests)

        (out, secs), launches["serving"] = counter.counted(lambda: run.serve("hopper", requests))
        counter.expect("serving, %d requests of %d" % (REQUESTS, Unet.BATCH), launches["serving"], REQUESTS, 0)
        if out.shape != (len(requests), ) + Unet.SHAPE or not np.isfinite(out).all():
            fail("[%s] outputs of shape %s, finite: %s" % (tag, out.shape, np.isfinite(out).all()))

        Config.gemmAlgo = Config.convAlgo = "hopper"
        logitsRel = _relL2(run.net(first.to(torch.bfloat16)).float(), refLogits)
        run.net.reset()
        rel = _relL2(torch.from_numpy(out[:Unet.BATCH]).cuda(), refOut)
        print("[%s] serving %d images: %.4f s; the first request against the same f32 weights on the library route, "
              "relative L2: logits %.3e, sigmoid outputs %.3e (bound %.0e each)" %
              (tag, len(requests), secs, logitsRel, rel, SLICE_BOUND))
        if not (logitsRel <= SLICE_BOUND and rel <= SLICE_BOUND):
            fail("[%s] served logits %.3e, sigmoid outputs %.3e from the f32 library run" % (tag, logitsRel, rel))
        del refOut, refLogits

        # the backward of one forward, every variable
        run.restore()
        backward = _backwardGrads(torch, Config, run.trainer, net, images, masks, names=None, batch=Unet.BATCH,
                                  seeds=RESNET_GRAD_SEEDS)
        _resnetGradsAgainst(tag, backward, convs)
        del backward

        # eager training, hand and library routes
        for algo in ("torch", "hopper"):
            run.train(algo, images, masks)

        losses, libLosses = [], []
        secs, launches["training"] = counter.counted(lambda: run.train("hopper", images, masks, losses))
        counter.expect("training, %d steps of %d" % (Unet.STEPS, Unet.BATCH), launches["training"], Unet.STEPS, 1)
        print("[%s] training: %d images in %d steps, %.4f s" % (tag, len(images), Unet.STEPS, secs))
        _sameBitsAgain(tag, torch, run, "hopper", images, masks, losses, "eager hand route")

        run.train("torch", images, masks, libLosses)
        _lossesAgainst(tag, losses, libLosses, TRAIN_BOUND)
        for route, seen in (("hand", losses), ("library", libLosses)):
            if any(later > earlier for earlier, later in zip(seen, seen[1:])):
                fail("[%s] the %s route's loss grew from a step to the next at a learning rate of %g: %s" %
                     (tag, route, Unet.LEARN_RATE, seen))

        # validation on the library route's trained weights, with its
        # controls: those weights in f32 on the library route, and the input
        # one bf16 ulp apart
        errors = {algo: run.validate(algo, valImages, valMasks)[0] for algo in ("hopper", "torch")}
        _, launches["validation"] = counter.counted(lambda: run.validate("hopper", valImages, valMasks))
        counter.expect("validation of %d images" % len(valImages), launches["validation"],
                       len(valImages) // Unet.BATCH, 0)

        f32Error = _f32Validation(Unet, net, valImages, valMasks)
        controls = [abs(f32Error - errors["torch"])]
        for seed in RESNET_GRAD_SEEDS:
            moved = _ulpApart(torch, torch.from_numpy(valImages).to("cuda", torch.bfloat16), seed)
            controls.append(abs(run.validate("torch", moved.float().cpu().numpy(), valMasks)[0] - errors["torch"]))
        gap = abs(errors["hopper"] - errors["torch"])
        print("[%s] validation error of %d images on the library route's trained weights (share of pixels whose "
              "logit's sign misses the mask): hand %r, library %r, apart by %.3e; the library's own from those "
              "weights in f32 %.3e (f32 %r), from the input one bf16 ulp apart %s" %
              (tag, len(valImages), errors["hopper"], errors["torch"], gap, controls[0], f32Error,
               " ".join("%.3e" % c for c in controls[1:])))
        if not gap <= max(controls):
            fail("[%s] the hand route's validation error is %.3e from the library's, past its control %.3e" %
                 (tag, gap, max(controls)))

        # the fused forms
        _fusedAgainstEager(tag, torch, run, counter, launches, images, masks, losses, valImages, valMasks)

        eagerOut, _ = run.serve("hopper", requests)
        run.serve("fused", requests)
        (fusedOut, _), launches["fusedServing"] = counter.counted(lambda: run.serve("fused", requests))
        counter.expect("FusedCalculator, %d requests of %d" % (REQUESTS, Unet.BATCH), launches["fusedServing"],
                       REQUESTS, 0)
        rel = float(np.linalg.norm(fusedOut - eagerOut) / np.linalg.norm(eagerOut))
        print("[%s] FusedCalculator against Calculator: relative L2 %.3e (bound %.0e), bit-equal %s; recordings %d" %
              (tag, rel, SLICE_BOUND, np.array_equal(fusedOut, eagerOut), run.fusedCalculator._program.captures))
        if not rel <= SLICE_BOUND or run.fusedCalculator._program.captures != 1:
            fail("[%s] FusedCalculator outputs %.3e from Calculator's" % (tag, rel))

        # rates and idle shares
        _routeRates(tag, card, {"training": (len(images), lambda algo: run.train(algo, images, masks)),
                                "serving": (len(requests), lambda algo: run.serve(algo, requests)[1]),
                                "validation": (len(valImages), lambda algo: run.validate(algo, valImages,
                                                                                         valMasks)[1])})
        _idleShares(tag, run, images[:2 * Unet.BATCH], masks[:2 * Unet.BATCH])
        print("[%s] peak device memory of the phase %.2f GB" % (tag, torch.cuda.max_memory_allocated() / 1e9))

    Config.gemmAlgo = Config.convAlgo = "hopper"
    del run, net
    torch.cuda.empty_cache()
    return launches, _convKernels(torch, winograd, tag, Unet.KERNEL_CONVS, Unet.BATCH)


def _f32Validation(Unet, net, images, masks):
    """The validation error of ``net``'s weights (bf16, as training left
    them) in an f32 U-Net on the library route (TF32 off): how far the bf16
    library route's rounding alone moves the error on those weights."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
    from puzzlelib_tpu_torch.cost import BCE
    from puzzlelib_tpu_torch.handlers import Validator

    evalMode, Config.globalEvalMode = Config.globalEvalMode, True
    try:
        ref = Unet.build(initscheme="none")
    finally:
        Config.globalEvalMode = evalMode

    ref.pop()   # the sigmoid: BCE takes the logits
    paramsFromNumpy(ref, paramsToNumpy(net))

    Config.gemmAlgo = Config.convAlgo = "torch"
    try:
        return Validator(ref, BCE(), batchsize=Unet.BATCH).validateFromHost(images, masks, macroBatchSize=len(images))
    finally:
        Config.gemmAlgo = Config.convAlgo = "hopper"


def phaseInception(torch, card):
    """Inception-BN (224 x 224) and Inception-v3 (299 x 299) in bf16 with
    f32 batch norms at batch 32 (``tools/inceptionslice.py``), He weights
    from ``np.random.seed(0)``: 4 requests each through ``Calculator`` on
    the hand and library routes and through ``FusedCalculator``; one K1 a
    request (``fc1``, on wgmma) on each net and one K2 a request on each of
    Inception-BN's two Winograd convs (counted from the net), none on
    Inception-v3's; the first request's logits on the hand route within
    5e-2 relative L2 of the same f32 weights on the library route, the
    fused probabilities within 5e-2 of the eager ones; images/s of each
    route (5 runs in turns).  Then K1 at both ``fc1`` shapes and K2 at
    Inception-BN's 14 x 14 shape against cuBLAS and channels-last cuDNN.
    Returns the launches and the kernels' numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd
    from puzzlelib_tpu_torch.tools import inceptionslice as Inc

    Config.device = "cuda"
    tag = "inception"
    launches = {}

    for kind in ("bn", "v3"):
        name = Inc.NAMES[kind]
        net = Inc.build(kind)
        images = Inc.data(kind, Inc.BATCH * REQUESTS)
        first = torch.from_numpy(images[:Inc.BATCH]).cuda()

        # the f32 reference: the same weights on the library route (TF32 off)
        Config.gemmAlgo = Config.convAlgo = "torch"
        net(first)
        refLogits = net.graph[-2].data.float().clone()
        net.reset()

        run = Inc.buildRun(kind, net=net)
        convs = Res.winogradConvs(net, (Inc.BATCH, ) + Inc.SHAPES[kind])
        print("[%s] %s bf16 (batch norms f32) at batch %d, %d parameters, %d convs, of which K2 takes %d: %s" %
              (tag, name, Inc.BATCH, net.numOfParams(), len(Res.convInputs(net, (Inc.BATCH, ) + Inc.SHAPES[kind])),
               len(convs), " ".join(convs) or "none"))

        outs = {}
        for algo in ("torch", "hopper", "fused"):
            run.serve(algo, images)
            _resetCounters()
            outs[algo], _ = run.serve(algo, images)
            counts = _readCounters()
            launches[kind, algo] = {key: counts[key] for key in ("winograd", "matmul", "matmulWgmma")}

        want = {"winograd": len(convs) * REQUESTS, "matmul": REQUESTS, "matmulWgmma": REQUESTS}
        print("[%s] %s, %d requests of %d: launches on the hand route %s, fused %s, library %s" %
              (tag, name, REQUESTS, Inc.BATCH, launches[kind, "hopper"], launches[kind, "fused"],
               launches[kind, "torch"]))
        if launches[kind, "hopper"] != want or launches[kind, "fused"] != want or \
                launches[kind, "torch"] != dict.fromkeys(want, 0):
            fail("[%s] %s: expected launches %s on the hand and fused routes, none on the library's" %
                 (tag, name, want))

        Config.gemmAlgo = Config.convAlgo = "hopper"
        net(first.to(torch.bfloat16))
        rel = _relL2(net.graph[-2].data.float(), refLogits)
        net.reset()
        fusedRel = float(np.linalg.norm(outs["fused"] - outs["hopper"]) / np.linalg.norm(outs["hopper"]))
        libRel = float(np.linalg.norm(outs["torch"] - outs["hopper"]) / np.linalg.norm(outs["torch"]))
        print("[%s] %s: the first request's logits against the same f32 weights on the library route: relative L2 "
              "%.3e (bound %.0e); probabilities fused against eager %.3e, bit-equal %s; eager against the bf16 "
              "library route %.3e" % (tag, name, rel, SLICE_BOUND, fusedRel,
                                      np.array_equal(outs["fused"], outs["hopper"]), libRel))
        if not (rel <= SLICE_BOUND and fusedRel <= SLICE_BOUND) or not np.isfinite(outs["hopper"]).all():
            fail("[%s] %s logits %.3e from the f32 library run, fused %.3e from eager" % (tag, name, rel, fusedRel))

        routes = {"hopper": "eager hand route", "torch": "library route (cuDNN / cuBLAS)", "fused": "fused route"}
        fns = {algo: (lambda algo=algo: run.serve(algo, images)[1]) for algo in routes}
        for algo, secs in _turns({}, fns).items():
            print("[%s] %s, %s, serving, 5 runs in turns: %s s, median %.1f images/s on %s" %
                  (tag, name, routes[algo], " ".join("%.4f" % t for t in secs), len(images) / float(np.median(secs)),
                   card))

        Config.gemmAlgo = Config.convAlgo = "hopper"
        del run, net, first, refLogits
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(6)
    kernels = {}
    for kind in ("bn", "v3"):
        label, k, n = Inc.FC1[kind]
        gemm = _gemmCase(torch, matmul, gen, "%s-%s" % (label, kind), "bf16", Inc.BATCH, k, n)
        kernels["K1", kind] = {"max_abs_err": gemm["abs_err"], "ms": gemm["ms"], "plain_ms": gemm["plain_ms"],
                               "bound_ms": gemm["bound_ms"], "bound_by": gemm["bound_by"],
                               "library_ms": gemm["library_ms"]}

    kernels["K2"] = _convKernels(torch, winograd, tag, Inc.KERNEL_CONVS, Inc.BATCH, tags=("K2", ))["K2"]
    return launches, kernels


# -- the sequence slice --------------------------------------------------------------------------------

def _itemReads(torch, fn):
    """(fn(), the number of ``Tensor.item`` readbacks it made)."""
    item, reads = torch.Tensor.item, [0]

    def counted(tensor):
        reads[0] += 1
        return item(tensor)

    torch.Tensor.item = counted
    try:
        return fn(), reads[0]
    finally:
        torch.Tensor.item = item


# [imdb-rnn]: the runs in turns of each route's rate (5 until [engine-driver]
# came: 3 pay for its time)
IMDB_RATE_TURNS = 3


def phaseImdbRnn(torch, card):
    """The three IMDB sentiment nets of ``tools/sequenceslice.py`` (LSTM,
    BiLSTM, 1-d CNN) at full width in f32, weights from
    ``np.random.seed(0)``, ``Adam(1e-3)`` in global state and ``BCE``: 4
    steps of 32 seeded token rows through ``Trainer`` on the hand route, the
    library route and ``FusedTrainer`` (once each to warm up, then counted):
    the hand and fused losses within 5e-2 of the library route's and fused
    within 5e-2 of eager's, the hand route twice the same bits; K1 takes
    each ``Linear`` head forward, one launch a step per head, none on the
    library route; ``Validator`` and ``FusedValidator`` over 128 rows, each
    call one readback, the fused error equal to eager's and K1's launches
    counted; rows/s of each route in ``IMDB_RATE_TURNS`` runs in turns, and
    the idle share of a profiled run, fused and eager, its K1 launches held to the profiler's
    device events.  Then K1 at the four head products against its plain
    version, cuBLAS and the bound.  Returns the launches and the JSON
    entry's numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul

    Config.device = "cuda"
    tag = "imdb-rnn"
    launches = dict.fromkeys(("hopper", "torch", "fused", "validate", "fusedValidate"), 0)

    for kind in Seq.NETS:
        run = Seq.buildRun(kind)
        images, labels = Seq.data(kind, Seq.BATCH * Seq.STEPS)
        valImages, valLabels = Seq.data(kind, Seq.VALIDATION, seed=2)
        heads = len(Seq.GEMMS[kind])
        print("[%s] %s f32 at batch %d, %d parameters, %d tokens a row" %
              (tag, kind, Seq.BATCH, run.net.numOfParams(), images.shape[1]))

        for algo in SLICE_ROUTES:
            run.train(algo, images, labels)
            run.validate(algo, valImages, valLabels)

        # the hand route last: _sameBitsAgain holds a second run to the
        # weights the run before it left
        losses, counts = {}, {}
        for algo in ("torch", "fused", "hopper"):
            losses[algo] = []
            _resetCounters()
            run.train(algo, images, labels, losses[algo])
            counts[algo] = matmul.launches
            launches[algo] += counts[algo]

        want = {"hopper": heads * Seq.STEPS, "torch": 0, "fused": heads * Seq.STEPS}
        print("[%s] %s, %d steps of %d: K1 launches %s (expected %s); recordings %d" %
              (tag, kind, Seq.STEPS, Seq.BATCH, counts, want, run.fusedTrainer.step.captures))
        if counts != want or run.fusedTrainer.step.captures != 1:
            fail("[%s] %s: K1 launches %s, expected %s; recordings %d" %
                 (tag, kind, counts, want, run.fusedTrainer.step.captures))

        _lossesAgainst("%s] [%s" % (tag, kind), losses["hopper"], losses["torch"], TRAIN_BOUND)
        _lossesAgainst("%s] [%s" % (tag, kind), losses["fused"], losses["hopper"], TRAIN_BOUND,
                       ref="eager hand route")
        _sameBitsAgain("%s] [%s" % (tag, kind), torch, run, "hopper", images, labels, losses["hopper"],
                       "hand route")

        errors = {}
        for algo in SLICE_ROUTES:
            _resetCounters()
            (errors[algo], _), reads = _itemReads(torch, lambda: run.validate(algo, valImages, valLabels))
            if algo != "torch":
                launches["validate" if algo == "hopper" else "fusedValidate"] += matmul.launches
            print("[%s] %s, %s: validation error of %d rows %r, %d readback(s), K1 launches %d" %
                  (tag, kind, SLICE_ROUTES[algo], len(valImages), errors[algo], reads, matmul.launches))
            if reads != 1 or not np.isfinite(errors[algo]):
                fail("[%s] %s: the %s's validation read back %d times, error %r" %
                     (tag, kind, SLICE_ROUTES[algo], reads, errors[algo]))
        if errors["fused"] != errors["hopper"]:
            fail("[%s] %s: fused validation error %r against eager %r" % (tag, kind, errors["fused"],
                                                                          errors["hopper"]))

        fns = {algo: (lambda algo=algo: run.train(algo, images, labels)) for algo in SLICE_ROUTES}
        for algo, secs in _turns({}, fns, IMDB_RATE_TURNS).items():
            print("[%s] %s, %s, training, %d runs in turns: %s s, median %.1f rows/s on %s" %
                  (tag, kind, SLICE_ROUTES[algo], IMDB_RATE_TURNS, " ".join("%.4f" % t for t in secs),
                   len(images) / float(np.median(secs)), card))

        _idleShares("%s] [%s" % (tag, kind), run, images, labels)
        Config.gemmAlgo = Config.convAlgo = "hopper"
        del run
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(9)
    main = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    for kind in Seq.NETS:
        for name, m, k, n in Seq.GEMMS[kind]:
            _addCase(main, binding, _gemmCase(torch, matmul, gen, name, "f32", m, k, n))
    main["bound_by"] = "/".join(sorted(binding))
    del main["wmma_ms"]
    return launches, main


def _w2lRepeats(torch, run, frames, labels, lengths):
    """{op: bit-equal} of the ops of a Wave2Letter step called twice on the
    same inputs on the card: CTC, and the backward of the first two blocks'
    reflect pads, 1-d convs (data and filter) and the first batch norm."""
    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.ops import conv as convOps
    from puzzlelib_tpu_torch.ops import ctc
    from puzzlelib_tpu_torch.ops import pad as padOps

    run.net.trainMode()
    out = run.net(gpuarray.to_gpu(frames[:run.batch], dtype=run.net.calctype))
    scores = out.float().permute(2, 0, 1).contiguous()
    lens = lengths[:run.batch]
    datalen = np.full(run.batch, scores.shape[0], dtype=np.int32)
    gen = torch.Generator(device="cuda").manual_seed(3)

    checks = {"CTC": lambda: ctc.ctcLoss(scores, datalen, labels[:int(lens.sum())], lens, Seq.W2L_BLANK)}
    graph = run.net.graph
    bn = graph[2]
    bnGrad = torch.randn(bn.data.shape, device="cuda", generator=gen).to(bn.data.dtype)
    checks["batch-norm backward"] = lambda: (bn.updateGrad(bnGrad), bn.grad)[1:]

    for block, (pad, conv) in enumerate(((graph[0], graph[1]), (graph[5], graph[6]))):
        grad = torch.randn(conv.data.shape, device="cuda", generator=gen).to(conv.data.dtype)
        args = (conv.stride, conv.pad, conv.dilation, conv.groups)
        checks["block %d conv1d backward (data)" % block] = \
            lambda conv=conv, grad=grad, args=args: [convOps.convNdBackwardData(grad, conv.W, tuple(conv.inData.shape),
                                                                                 *args)]
        checks["block %d conv1d backward (filter)" % block] = \
            lambda conv=conv, grad=grad, args=args: convOps.convNdBackwardParams(conv.inData, grad, conv.W, *args,
                                                                                 hasBias=True)
        checks["block %d reflect-pad backward" % block] = \
            lambda pad=pad, conv=conv: [padOps.reflectpadBackward(conv.inData, (tuple(pad.pad), ))]

    repeats = {}
    for name, fn in checks.items():
        first, second = fn(), fn()
        repeats[name] = all(torch.equal(a, b) for a, b in zip(first, second))

    run.net.reset()
    return repeats


def phaseW2L(torch, card):
    """Wave2Letter (``tools/sequenceslice.py``) at full width, 161 input
    features and 29 labels, 8 x 161 x 1600 frames a batch, weights from
    ``np.random.seed(0)``, ``Adam(W2L_ALPHA)`` in global state: in f32, 1
    request served and 4 steps trained on the loop of
    ``testlib/ctctrain.py``; in bf16 (batch norms f32), 4 requests served
    through ``Calculator`` (dropout off) and 4 steps trained: the first
    request's scores within 5e-2 relative L2 of the f32 run's, the losses
    finite, falling at every step and within 5e-2 of the f32 run's; CTC on
    the card at the first batch's scores within 1e-4 relative of
    ``hostCTCLoss`` in f64, error and gradient; a second bf16 run from the
    same start the same bits, or else the op that does not repeat named and
    the two held within 5e-2; images/s served and trained, 5 runs each in
    turns.  No hand kernel runs on this path (the 1-d convs go to cuDNN, as
    to XLA in the JAX package)."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops import ctc

    Config.device = "cuda"
    Config.gemmAlgo = Config.convAlgo = "hopper"
    tag = "w2l"
    batch = Seq.W2L_BATCH
    frames, labels, lengths = Seq.w2lData(batch * Seq.W2L_STEPS)

    run32 = Seq.W2LRun(Seq.buildW2L(torch.float32))
    out32, _ = run32.serve(frames[:batch])
    losses32 = []
    run32.train(frames, labels, lengths, losses32)
    del run32
    torch.cuda.empty_cache()

    run = Seq.W2LRun(Seq.buildW2L())
    print("[%s] Wave2Letter bf16 (batch norms f32), %d parameters, batch %d of %d x %d frames, %d to %d labels a "
          "sample, Adam(%g) in global state" % (tag, run.net.numOfParams(), batch, Seq.W2L_INMAPS, Seq.W2L_FRAMES,
                                                 Seq.W2L_LABEL_RANGE[0], Seq.W2L_LABEL_RANGE[1], Seq.W2L_ALPHA))

    run.serve(frames)
    _resetCounters()
    out, secs = run.serve(frames)
    counts = _readCounters()
    rel = float(np.linalg.norm(out[:batch] - out32) / np.linalg.norm(out32))
    print("[%s] %d requests of %d: scores %s, finite %s, %.4f s; the first request's against f32: relative L2 %.3e "
          "(bound %.0e); hand-kernel launches %s" %
          (tag, Seq.W2L_REQUESTS, batch, out.shape, np.isfinite(out).all(), secs, rel, SLICE_BOUND,
           {key: n for key, n in counts.items() if n}))
    if out.shape != (len(frames), Seq.W2L_LABELS, Seq.W2L_FRAMES // 2) or not np.isfinite(out).all() \
            or not rel <= SLICE_BOUND:
        fail("[%s] served scores %s, relative L2 %.3e from f32" % (tag, out.shape, rel))

    scores = torch.from_numpy(out[:batch]).cuda().permute(2, 0, 1).contiguous()
    lens = lengths[:batch]
    datalen = np.full(batch, scores.shape[0], dtype=np.int32)
    err, grad = ctc.ctcLoss(scores, datalen, labels[:int(lens.sum())], lens, Seq.W2L_BLANK)
    hostErr, hostGrad, _ = ctc.hostCTCLoss(out[:batch].transpose(2, 0, 1), datalen, labels[:int(lens.sum())], lens,
                                           Seq.W2L_BLANK)
    errRel = abs(err.item() - float(hostErr)) / abs(float(hostErr))
    gradRel = float(np.abs(-grad.cpu().numpy() - hostGrad).max() / np.abs(hostGrad).max())
    print("[%s] CTC on the card at (T, B, V) = %s against hostCTCLoss in f64: error %.6f against %.6f, relative %.3e; "
          "gradient max |diff| / max |host| %.3e (bound %.0e)" %
          (tag, tuple(scores.shape), err.item(), float(hostErr), errRel, gradRel, CTC_HOST_BOUND))
    if not (errRel <= CTC_HOST_BOUND and gradRel <= CTC_HOST_BOUND):
        fail("[%s] CTC against hostCTCLoss: error %.3e, gradient %.3e" % (tag, errRel, gradRel))

    run.train(frames, labels, lengths)
    losses = []
    _resetCounters()
    run.train(frames, labels, lengths, losses)
    counts = _readCounters()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses32))
    falling = all(b < a for a, b in zip(losses, losses[1:]))
    print("[%s] %d steps of %d, bf16: losses %s; f32: %s; largest relative difference %.3e (bound %.0e); falling at "
          "every step %s; hand-kernel launches %s" %
          (tag, Seq.W2L_STEPS, batch, " ".join("%.4f" % v for v in losses), " ".join("%.4f" % v for v in losses32),
           rel, TRAIN_BOUND, falling, {key: n for key, n in counts.items() if n}))
    if not (np.isfinite(losses).all() and falling and rel <= TRAIN_BOUND and len(losses) == Seq.W2L_STEPS):
        fail("[%s] bf16 losses %s against f32 %s" % (tag, losses, losses32))

    weights = {dtype: pack.ary.clone() for dtype, pack in run.optimizer.shParams.items()}
    again = []
    run.train(frames, labels, lengths, again)
    same = again == losses and all(torch.equal(run.optimizer.shParams[dtype].ary, ary)
                                   for dtype, ary in weights.items())
    print("[%s] a second bf16 run from the same start: losses and weights bit-equal %s" % (tag, same))
    repeats = _w2lRepeats(torch, run, frames, labels, lengths)
    print("[%s] ops called twice on the same inputs, bit-equal: %s" %
          (tag, ", ".join("%s %s" % (name, ok) for name, ok in repeats.items())))
    if not same:
        rel = max(abs(a - b) / abs(b) for a, b in zip(again, losses))
        print("[%s] the runs differ: ops that do not repeat: %s; losses %s against %s, largest relative difference "
              "%.3e (bound %.0e)" % (tag, ", ".join(name for name, ok in repeats.items() if not ok) or "none found",
                                     again, losses, rel, TRAIN_BOUND))
        if not rel <= TRAIN_BOUND:
            fail("[%s] a second run's losses %s against %s" % (tag, again, losses))

    fns = {"serve": lambda: run.serve(frames)[1], "train": lambda: run.train(frames, labels, lengths)}
    for what, secs in _turns({}, fns).items():
        print("[%s] %s, 5 runs in turns: %s s, median %.2f images/s on %s" %
              (tag, "serving" if what == "serve" else "training", " ".join("%.4f" % t for t in secs),
               len(frames) / float(np.median(secs)), card))

    del run
    torch.cuda.empty_cache()


# -- the zoo slice -----------------------------------------------------------------------------------

class _LinearLaunches(_LayerLaunches):
    """K1 launches, all of them and those on wgmma, counted inside each
    named Linear's forward (its ``updateData``, wrapped on the instance)."""

    FIELDS = ("launches", "wgmma")
    METHODS = ("updateData", )

    def _now(self):
        return self.kernels.launches, self.kernels.launchesWgmma

    def table(self):
        return {name: self._tuple(name) for name in self.counts}


def phaseZooVision(torch, card):
    """MiniYolo (448 x 448, 1470 outputs, batch 16), OpenPose COCO and
    OpenPose MPI (368 x 368, batch 8) at full width in bf16
    (``tools/zooslice.py``), He weights from ``np.random.seed(0)``: 4
    requests each through ``Calculator`` on the hand and library routes
    and through ``FusedCalculator``, the counters reset just before and read
    just after each counted run.  One K2 a request on each of the convs
    ``winograd.applicable`` takes (12, 15 and 12, counted from the net and
    inside each conv), and on MiniYolo one K1 a request inside each of
    fc25, fc26 (on wgmma) and fc27 (N = 1470: WMMA); the same on the fused
    route and in the profiler's device events, none on the library route.
    The first request's outputs (MiniYolo's fc27 logits) on the hand route
    within 5e-2 relative L2 of the same weights in f32 on the library
    route; the fused outputs equal to the eager ones; images/s of each route
    in 5 runs in turns.  Then K2 at each of the three nets' Winograd convs
    against channels-last cuDNN, and K1 at fc25-fc27 against cuBLAS.
    Returns the launches and the kernels' numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    tag = "zoo-vision"
    launches, kernels = {}, {}

    for kind in Zoo.NETS:
        name, batch = Zoo.NAMES[kind], Zoo.BATCH[kind]
        net = Zoo.build(kind)
        images = Zoo.data(kind, batch * REQUESTS)
        first = torch.from_numpy(images[:batch]).cuda()
        fcs = [fc for fc, _, _ in Zoo.YOLO_FC] if kind == "miniyolo" else []

        def output():
            return (net.graph[-2].data if fcs else net.data).float()

        # the f32 reference: the same weights on the library route (TF32 off)
        Config.gemmAlgo = Config.convAlgo = "torch"
        net(first)
        ref = output().clone()
        net.reset()

        run = Zoo.buildRun(kind, net=net)
        convs = Zoo.winogradConvs(net, kind)
        kernelConvs = Zoo.kernelConvs(net, kind)
        print("[%s] %s bf16 at batch %d on %s, %d parameters, %d convs, of which K2 takes %d: %s" %
              (tag, name, batch, "x".join(map(str, Zoo.SHAPES[kind])), net.numOfParams(),
               len(Res.convInputs(net, (batch, ) + Zoo.SHAPES[kind])), len(convs), " ".join(convs)))

        outs = {}
        wantLinears = {fc: (REQUESTS, REQUESTS if fc != "fc27" else 0) for fc in fcs}
        want = {"winograd": len(convs) * REQUESTS, "winogradDataGrad": 0, "winogradFG": 0,
                "matmul": len(fcs) * REQUESTS, "matmulWgmma": sum(w for _, w in wantLinears.values())}

        with _SliceLaunches(tag, winograd, net, convs, 0) as counter, _LinearLaunches(matmul, net, fcs) as linears:
            for algo in ("torch", "hopper", "fused"):
                run.serve(algo, images)
                linears.reset()
                (outs[algo], _), counts = counter.counted(lambda: run.serve(algo, images))
                launches[kind, algo] = counts
                hand = algo != "torch"

                print("[%s] %s, %s, %d requests of %d: launches %s; K1 by layer (all, on wgmma) %s" %
                      (tag, name, SLICE_ROUTES[algo], REQUESTS, batch, counts, linears.table()))
                counter.layers.check("%s] [%s" % (tag, kind), (REQUESTS if hand else 0, 0, 0))
                if counts != (want if hand else dict.fromkeys(want, 0)) or \
                        linears.table() != (wantLinears if hand else dict.fromkeys(fcs, (0, 0))):
                    fail("[%s] %s on the %s: launches %s, K1 by layer %s; expected %s, %s" %
                         (tag, name, SLICE_ROUTES[algo], counts, linears.table(), want, wantLinears))

        idle = {algo: _profiledLaunches("%s] [%s" % (tag, kind), lambda algo=algo: run.serve(algo, images)[1])[1]
                for algo in ("fused", "hopper")}

        Config.gemmAlgo = Config.convAlgo = "hopper"
        net(first.to(torch.bfloat16))
        rel = _relL2(output(), ref)
        net.reset()
        same = np.array_equal(outs["fused"], outs["hopper"])
        libRel = float(np.linalg.norm(outs["torch"] - outs["hopper"]) / np.linalg.norm(outs["torch"]))
        print("[%s] %s: the first request's %s against the same f32 weights on the library route: relative L2 %.3e "
              "(bound %.0e); fused outputs equal to eager's %s; eager against the bf16 library route %.3e; idle "
              "share under the profiler fused %.1f %%, eager %.1f %%" %
              (tag, name, "fc27 logits" if fcs else "output maps", rel, SLICE_BOUND, same, libRel,
               100 * idle["fused"], 100 * idle["hopper"]))
        if not (rel <= SLICE_BOUND and same and np.isfinite(outs["hopper"]).all()):
            fail("[%s] %s: relative L2 %.3e from the f32 library run, fused equal to eager %s" % (tag, name, rel, same))

        fns = {algo: (lambda algo=algo: run.serve(algo, images)[1]) for algo in SLICE_ROUTES}
        for algo, secs in _turns({}, fns).items():
            print("[%s] %s, %s, serving, 5 runs in turns: %s s, median %.1f images/s on %s" %
                  (tag, name, SLICE_ROUTES[algo], " ".join("%.4f" % t for t in secs),
                   len(images) / float(np.median(secs)), card))

        del run, net, first, ref, outs
        torch.cuda.empty_cache()
        kernels["K2", kind] = _convKernels(torch, winograd, "%s] [%s" % (tag, kind), kernelConvs, batch,
                                           tags=("K2", ))["K2"]

    gen = torch.Generator(device="cuda").manual_seed(10)
    main = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    for fc, k, n in Zoo.YOLO_FC:
        _addCase(main, binding, _gemmCase(torch, matmul, gen, "yolo-%s" % fc, "bf16", Zoo.BATCH["miniyolo"], k, n))
    main["bound_by"] = "/".join(sorted(binding))
    del main["wmma_ms"]
    kernels["K1"] = main
    return launches, kernels


def phaseSentiNet(torch, card):
    """SentiNet at its preset's widths (``tools/zooslice.py``: a vocabulary
    of 20000 words, sentences of 100 words padded by 4 on each side,
    embeddings of 300, branches 3, 4 and 5 of 100 maps, 2 classes) in f32,
    weights from ``np.random.seed(0)``, on 2048 seeded sentences.  The
    preset (``presets.sentinet.train(..., saving=False)``: ``AdaDelta``,
    ``CrossEntropy``, ``Trainer`` at batch 64, ``Validator``, 3 epochs) on
    the hand and library routes from the same start: K1 one launch a step
    and a validated batch (the head), none on the library route; the
    epochs' mean training errors within 1e-4 relative of the library
    route's and falling; the validation errors equal; then 256 sentences
    served through ``Calculator`` on both routes.  Then each of the six new
    optimizers in global state, 4 steps of 64 on the eager hand route, the
    eager library route and ``FusedTrainer``: the hand losses within 1e-4
    of the library's, the fused losses equal to eager's (the fused form
    rounds its scalars as the eager one: no split), a second fused run the
    same bits, one recording, K1 one a step on the hand and fused routes;
    rows/s of each route in 5 runs in turns.  Then K1 at the head's product
    against cuBLAS.  Returns the launches and the kernel's numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul

    Config.device = "cuda"
    tag = "sentinet"
    run = Zoo.SentiRun()
    tokens, labels = Zoo.sentiData()
    launches = {}
    print("[%s] SentiNet f32, %d parameters, %d sentences of %d tokens (vocabulary %d, embeddings %d, branches %s "
          "of %d maps)" % (tag, run.net.numOfParams(), len(tokens), tokens.shape[1], Zoo.SENTI_VOCAB,
                           Zoo.SENTI_EMBSIZE, Zoo.SENTI_BRANCHES, Zoo.SENTI_MAPS))

    # the preset calls optimizeForShape, which races the head's K1 against
    # cuBLAS (33 K1 launches); raced here, before the counted runs, the
    # preset's own calls find the product measured and launch nothing
    from puzzlelib_tpu_torch.modules import Linear
    for head in run.net.getAllByType(Linear):
        head.optimizeForShape((Zoo.SENTI_BATCH, head.W.shape[0]))
    print("[%s] the head's race before the counted runs (K1 ms, cuBLAS ms): %s -> %s" %
          (tag, matmul._raceMs, matmul._dispatch))

    presets = {}
    for algo in ("torch", "hopper"):
        _resetCounters()
        presets[algo] = run.preset(algo, tokens, labels)
        launches["preset", algo] = matmul.launches

    hand, lib = presets["hopper"], presets["torch"]
    batches = -(-hand.trainRows // Zoo.SENTI_BATCH) + -(-hand.valRows // 128)
    print("[%s] the preset, %d epochs of %d training and %d validation rows: K1 launches hand %d (expected %d), "
          "library %d; best accuracy hand %r, library %r; %.3f s and %.3f s" %
          (tag, Zoo.SENTI_EPOCHS, hand.trainRows, hand.valRows, launches["preset", "hopper"],
           Zoo.SENTI_EPOCHS * batches, launches["preset", "torch"], hand.accuracy, lib.accuracy, hand.seconds,
           lib.seconds))
    _lossesAgainst(tag, hand.trainErrors, lib.trainErrors, CNN_LOSS_BOUND)
    print("[%s] validation errors hand %s, library %s" % (tag, hand.valErrors, lib.valErrors))
    if launches["preset", "hopper"] != Zoo.SENTI_EPOCHS * batches or launches["preset", "torch"] != 0:
        fail("[%s] preset K1 launches %s" % (tag, launches))
    if len(hand.trainErrors) != Zoo.SENTI_EPOCHS or not hand.trainErrors[-1] < hand.trainErrors[0]:
        fail("[%s] the preset's training errors %s do not fall" % (tag, hand.trainErrors))
    if hand.valErrors != lib.valErrors:
        fail("[%s] validation errors %s against the library route's %s" % (tag, hand.valErrors, lib.valErrors))

    served = {}
    for algo in ("torch", "hopper"):
        Cnn._route(algo)
        served[algo], _ = run.serve(tokens[:256])
    rel = float(np.linalg.norm(served["hopper"] - served["torch"]) / np.linalg.norm(served["torch"]))
    print("[%s] 256 sentences served: scores %s, hand against library relative L2 %.3e (bound %.0e)" %
          (tag, served["hopper"].shape, rel, CNN_LOSS_BOUND))
    if served["hopper"].shape != (256, Zoo.SENTI_CLASSES) or not rel <= CNN_LOSS_BOUND:
        fail("[%s] served scores %s, %.3e from the library route's" % (tag, served["hopper"].shape, rel))

    rows, rowLabels = tokens[:Zoo.SENTI_BATCH * Zoo.SENTI_STEPS], labels[:Zoo.SENTI_BATCH * Zoo.SENTI_STEPS]
    launches["optimizers"] = {"hopper": 0, "fused": 0}
    for name in Zoo.OPTIMIZERS:
        optRun = run.optimizer(name)
        losses = {}
        for algo in SLICE_ROUTES:
            optRun.train(algo, rows, rowLabels)

        for algo in ("torch", "fused", "hopper"):
            losses[algo] = []
            _resetCounters()
            optRun.train(algo, rows, rowLabels, losses[algo])
            if algo != "torch":
                launches["optimizers"][algo] += matmul.launches
            if matmul.launches != (0 if algo == "torch" else Zoo.SENTI_STEPS):
                fail("[%s] %s on the %s: %d K1 launches" % (tag, name, SLICE_ROUTES[algo], matmul.launches))

        _lossesAgainst("%s] [%s" % (tag, name), losses["hopper"], losses["torch"], CNN_LOSS_BOUND)
        print("[%s] [%s] fused losses %s, equal to eager's %s; recordings %d" %
              (tag, name, " ".join("%.6f" % v for v in losses["fused"]), losses["fused"] == losses["hopper"],
               optRun.fusedTrainer.step.captures))
        if losses["fused"] != losses["hopper"] or optRun.fusedTrainer.step.captures != 1:
            fail("[%s] %s: fused losses %s against eager %s, recordings %d" %
                 (tag, name, losses["fused"], losses["hopper"], optRun.fusedTrainer.step.captures))
        _sameBitsAgain("%s] [%s" % (tag, name), torch, optRun, "fused", rows, rowLabels, losses["fused"],
                       "FusedTrainer")

        fns = {algo: (lambda algo=algo: optRun.train(algo, rows, rowLabels)) for algo in SLICE_ROUTES}
        for algo, secs in _turns({}, fns).items():
            print("[%s] [%s] %s, training, 5 runs in turns: %s s, median %.1f rows/s on %s" %
                  (tag, name, SLICE_ROUTES[algo], " ".join("%.4f" % t for t in secs),
                   len(rows) / float(np.median(secs)), card))

    Config.gemmAlgo = Config.convAlgo = "hopper"
    del run
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(11)
    case = _gemmCase(torch, matmul, gen, "senti-head", "f32", Zoo.SENTI_BATCH,
                     len(Zoo.SENTI_BRANCHES) * Zoo.SENTI_MAPS, Zoo.SENTI_CLASSES)
    return launches, {"max_abs_err": case["abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
                      "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def _costCases(np):
    """(cost name, constructor arguments, prediction, target) of the seven
    costs at a classifier's width, from a numpy seed, in f32."""
    rng = np.random.RandomState(12)
    batch, classes = 256, 1000
    scores = rng.randn(batch, classes).astype(np.float32)
    labels = rng.randint(0, classes, size=batch).astype(np.int32)
    dist = np.abs(rng.randn(batch, classes)).astype(np.float32)
    return [
        ("Abs", {}, scores, rng.randn(batch, classes).astype(np.float32)),
        ("Hinge", {}, scores, (rng.randint(0, 2, size=(batch, classes)) * 2 - 1).astype(np.int32)),
        ("SmoothL1", {}, scores, rng.randn(batch, classes).astype(np.float32)),
        ("SVM", {"mode": "l1"}, scores, labels),
        ("SVM", {"mode": "l2"}, scores, labels),
        ("L1Hinge", {}, [scores[:, :128].copy(), rng.randn(batch, 128).astype(np.float32)],
         rng.randint(0, 2, size=batch).astype(np.int32)),
        ("KLDivergence", {"normTarget": False}, scores, dist / dist.sum(axis=1, keepdims=True)),
        ("KLDivergence", {"normTarget": True}, scores, dist),
    ]


def phaseCosts(torch):
    """The seven new costs (``cost/``): each one's error, gradient and
    validation error on the card within 1e-5 relative of the same call on
    the CPU, in f32 (``Multi`` of ``MSE`` and ``CrossEntropy``, its list of
    errors and gradients too); ``Multi`` through a ``FusedValidator`` (the
    eager path: no ``calcValDev``) equal to the ``Validator``'s, and
    ``SVM`` through a recorded ``FusedValidator``: one recording, the error
    and ``mostProb`` (the last batch's predictions) equal to the eager
    Validator's."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch import cost as Costs
    from puzzlelib_tpu_torch import fused as Fused
    from puzzlelib_tpu_torch.containers import Parallel, Sequential
    from puzzlelib_tpu_torch.handlers import Validator
    from puzzlelib_tpu_torch.modules import Linear, Replicate

    tag = "costs"

    def tree(fn, value):
        return [fn(v) for v in value] if isinstance(value, list) else fn(value)

    def call(device, name, kwargs, pred, target):
        Config.device = device
        cost = Costs.Multi().append(Costs.MSE()).append(Costs.CrossEntropy()) if name == "Multi" else \
            getattr(Costs, name)(**kwargs)
        pred, target = (tree(lambda a: torch.from_numpy(a).to(device), value) for value in (pred, target))
        err, grad = cost(pred, target)
        return tree(float, err), tree(lambda g: g.float().cpu(), grad), cost.validate(pred, target)

    cases = _costCases(np)
    rng = np.random.RandomState(13)
    cases.append(("Multi", {}, [rng.randn(64, 10).astype(np.float32), rng.randn(64, 5).astype(np.float32)],
                  [rng.randn(64, 10).astype(np.float32), rng.randint(0, 5, size=64).astype(np.int32)]))

    for name, kwargs, pred, target in cases:
        got, want = call("cuda", name, kwargs, pred, target), call("cpu", name, kwargs, pred, target)
        errs = []
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
                a, b = (a.numpy(), b.numpy()) if isinstance(a, torch.Tensor) else (np.float64(a), np.float64(b))
                errs.append(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
        print("[%s] %s %s: error, gradient and validation on the card against the CPU, largest relative difference "
              "%.3e (bound %.0e)" % (tag, name, kwargs or "", max(errs), COST_BOUND))
        if not max(errs) <= COST_BOUND:
            fail("[%s] %s %s on the card differs from the CPU by %.3e" % (tag, name, kwargs, max(errs)))

    Config.device = "cuda"
    np.random.seed(14)
    heads = Sequential(name="heads")
    heads.append(Linear(64, 128, name="trunk"))
    heads.append(Replicate(2))
    heads.append(Parallel().append(Linear(128, 10, name="head1")).append(Linear(128, 5, name="head2")))
    x = rng.randn(300, 64).astype(np.float32)
    targets = [rng.randn(300, 10).astype(np.float32), rng.randint(0, 5, size=300).astype(np.int32)]
    validator = Fused.FusedValidator(heads, Costs.Multi().append(Costs.MSE()).append(Costs.CrossEntropy()),
                                     batchsize=128)
    got = validator.validateFromHost(x, targets)
    want = Validator(heads, Costs.Multi().append(Costs.MSE()).append(Costs.CrossEntropy()),
                     batchsize=128).validateFromHost(x, targets)
    print("[%s] Multi through FusedValidator (eager path %s): %s; Validator: %s" %
          (tag, validator._fallback, got, want))
    if got != want or not validator._fallback:
        fail("[%s] Multi's FusedValidator errors %s against the Validator's %s" % (tag, got, want))

    svm = Sequential(name="svm")
    svm.append(Linear(64, 1000, name="fc"))
    scores = rng.randint(0, 1000, size=300).astype(np.int32)
    eagerCost, fusedCost = Costs.SVM(), Costs.SVM()
    want = Validator(svm, eagerCost, batchsize=128).validateFromHost(x, scores)
    validator = Fused.FusedValidator(svm, fusedCost, batchsize=128)
    got = validator.validateFromHost(x, scores)
    same = fusedCost.mostProb is not None and torch.equal(fusedCost.mostProb, eagerCost.mostProb)
    print("[%s] SVM through a recorded FusedValidator: error %r, Validator's %r; recordings %d; mostProb %s equal "
          "to eager's %s" % (tag, got, want, validator._program.captures,
                             None if fusedCost.mostProb is None else tuple(fusedCost.mostProb.shape), same))
    if got != want or validator._program.captures != 2 or not same:
        fail("[%s] SVM under FusedValidator: error %r against %r, recordings %d, mostProb equal %s" %
             (tag, got, want, validator._program.captures, same))


def phaseSegNet(torch, card):
    """SegNet in bf16 with f32 batch norms at batch 4 on 3 x 360 x 480
    (``tools/segslice.py``), He weights from ``np.random.seed(0)``.
    Serving: 4 requests through ``Calculator``; on the first, the encoder's
    output within 5e-2 relative L2 of the same f32 weights on the library
    route, and the scores within 5e-2 of the library route's bf16 forward
    on the hand route's pooling masks (bf16 rounding flips ~0.4-2 % of the
    masks against f32, and the unpools carry each flip to other cells, so
    the scores' distance from f32, printed with its controls, is no
    kernel's).  Training: ``CrossEntropy`` and ``MomentumSGD(LEARN_RATE, 0.9)``
    in global state, 4 steps on the hand and the library routes, the losses
    within 5e-2 of the library's and falling from each step to the next on
    both; the hand route twice, the same bits.  Fused: the same 4 steps
    through ``FusedTrainer`` (``_fusedAgainstEager``: the first loss
    bit-equal to eager's, the rest within 5e-2, twice the same bits, one
    recording), ``FusedValidator`` equal to ``Validator``,
    ``FusedCalculator`` equal to ``Calculator``.  Launches, counted from
    the net (``winogradConvs``) and inside each conv: one K2 a request and
    one K2, K2-bwd and K3 a step on each of its 20 Winograd convs, no K1;
    the fused ones also by the profiler.  Then images/s of each route (5
    runs in turns), the idle share of 2 profiled steps, and K2, K2-bwd and
    K3 at each of the 8 conv shapes against channels-last cuDNN, counted
    for each of the 20 convs.  Returns the launches and the kernels'
    numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import winograd
    from puzzlelib_tpu_torch.tools import segslice as Seg

    Config.device = "cuda"
    Config.globalEvalMode = False
    tag = "segnet"
    torch.cuda.reset_peak_memory_stats()

    net = Seg.build(torch.float32)
    images, labels = Seg.data(Seg.BATCH * Seg.STEPS)
    requests = images[:Seg.BATCH * REQUESTS]
    first = torch.from_numpy(requests[:Seg.BATCH]).cuda()

    # the f32 reference of serving: the same weights on the library route
    # (TF32 off), its scores, the encoder's output (pool5's) and the masks
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    refOut = net(first).float().clone()
    refFeatures = net.getByName("pool5").data.float().clone()
    refMasks = {name: mask.clone() for name, mask in Seg.masksOf(net).items()}
    net.reset()

    run = Seg.buildRun(Seg.setType(net, torch.bfloat16))
    convs = Seg.winogradConvs(net)
    kernelConvs = Seg.kernelConvs(net)
    print("[%s] SegNet bf16 at batch %d on %s inputs, %d parameters, %d convs, of which K2 / K3 take %d: %s; "
          "MomentumSGD(%g, %g), CrossEntropy" %
          (tag, Seg.BATCH, "x".join(map(str, Seg.SHAPE)), net.numOfParams(),
           len(Seg.convInputs(net, (Seg.BATCH, ) + Seg.SHAPE)), len(convs), " ".join(convs), Seg.LEARN_RATE,
           Seg.MOM_RATE))
    if len(convs) != 20:
        fail("[%s] expected 20 Winograd convs, found %d" % (tag, len(convs)))

    launches = {}
    with _SliceLaunches(tag, winograd, net, convs, 0) as counter:
        for algo in ("torch", "hopper"):
            run.serve(algo, requests)

        (out, secs), launches["serving"] = counter.counted(lambda: run.serve("hopper", requests))
        counter.expect("serving, %d requests of %d" % (REQUESTS, Seg.BATCH), launches["serving"], REQUESTS, 0)
        if out.shape != (len(requests), Seg.CLASSES) + Seg.SHAPE[1:] or out.dtype != np.float32 or \
                not np.isfinite(out).all():
            fail("[%s] outputs of shape %s, type %s, finite: %s" % (tag, out.shape, out.dtype, np.isfinite(out).all()))

        # bf16 rounding flips some of the pools' argmax masks, and the
        # decoder's unpools carry each flip to other cells, so the scores
        # are held on the hand route's own masks: the library route's bf16
        # forward with every pool taking its maxima where the hand route's
        # did; the encoder's output (before any unpool) against f32
        def forward(algo, x, masks=None):
            Config.gemmAlgo = Config.convAlgo = algo
            run.net.evalMode()
            with Seg.pinnedMasks(run.net, masks):
                result = run.net(x).float().clone()
            features = run.net.getByName("pool5").data.float().clone()
            taken = {name: mask.clone() for name, mask in Seg.masksOf(run.net).items()}
            run.net.reset()
            return result, features, taken

        x = first.to(torch.bfloat16)
        handOut, handFeatures, handMasks = forward("hopper", x)
        pinnedOut = forward("torch", x, handMasks)[0]
        libOut, libFeatures, _ = forward("torch", x)
        controls = [_relL2(forward("torch", _ulpApart(torch, x, seed))[0], libOut) for seed in RESNET_GRAD_SEEDS]
        Config.gemmAlgo = Config.convAlgo = "hopper"

        flips = {name: (mask != refMasks[name]).float().mean().item() for name, mask in handMasks.items()}
        relPinned, relFeatures = _relL2(handOut, pinnedOut), _relL2(handFeatures, refFeatures)
        print("[%s] serving %d images: %.4f s; the first request, relative L2: the encoder's output (pool5) "
              "against the same f32 weights on the library route, hand %.3e, library %.3e (bound %.0e); the "
              "scores against the library route's bf16 forward on the hand route's masks %.3e (bound %.0e); "
              "not held: the scores against f32 hand %.3e, library %.3e, the library's from its input one "
              "bf16 ulp apart %s; the share of the hand route's masks that differ from f32's %s" %
              (tag, len(requests), secs, relFeatures, _relL2(libFeatures, refFeatures), SLICE_BOUND, relPinned,
               SLICE_BOUND, _relL2(handOut, refOut), _relL2(libOut, refOut), " ".join("%.3e" % c for c in controls),
               ", ".join("%s %.4f" % item for item in flips.items())))
        if not (relFeatures <= SLICE_BOUND and relPinned <= SLICE_BOUND):
            fail("[%s] the encoder's output %.3e from the f32 library run, the scores %.3e from the library's on "
                 "the same masks" % (tag, relFeatures, relPinned))
        del refOut, refFeatures, refMasks, handMasks

        # eager training, hand and library routes
        for algo in ("torch", "hopper"):
            run.train(algo, images, labels)

        losses, libLosses = [], []
        secs, launches["training"] = counter.counted(lambda: run.train("hopper", images, labels, losses))
        counter.expect("training, %d steps of %d" % (Seg.STEPS, Seg.BATCH), launches["training"], Seg.STEPS, 1)
        print("[%s] training: %d images in %d steps, %.4f s" % (tag, len(images), Seg.STEPS, secs))
        _sameBitsAgain(tag, torch, run, "hopper", images, labels, losses, "eager hand route")

        run.train("torch", images, labels, libLosses)
        _lossesAgainst(tag, losses, libLosses, TRAIN_BOUND)
        for route, seen in (("hand", losses), ("library", libLosses)):
            if not all(later < earlier for earlier, later in zip(seen, seen[1:])):
                fail("[%s] the %s route's loss did not fall at every step at a learning rate of %g: %s" %
                     (tag, route, Seg.LEARN_RATE, seen))

        # the fused forms
        _fusedAgainstEager(tag, torch, run, counter, launches, images, labels, losses, requests,
                           labels[:len(requests)])

        eagerOut, _ = run.serve("hopper", requests)
        run.serve("fused", requests)
        (fusedOut, _), launches["fusedServing"] = counter.counted(lambda: run.serve("fused", requests))
        counter.expect("FusedCalculator, %d requests of %d" % (REQUESTS, Seg.BATCH), launches["fusedServing"],
                       REQUESTS, 0)
        same = np.array_equal(fusedOut, eagerOut)
        print("[%s] FusedCalculator against Calculator: bit-equal %s; recordings %d" %
              (tag, same, run.fusedCalculator._program.captures))
        if not same or run.fusedCalculator._program.captures != 1:
            fail("[%s] FusedCalculator's scores are not Calculator's" % tag)

        # rates and idle shares
        _routeRates(tag, card, {"training": (len(images), lambda algo: run.train(algo, images, labels)),
                                "serving": (len(requests), lambda algo: run.serve(algo, requests)[1])})
        _idleShares(tag, run, images[:2 * Seg.BATCH], labels[:2 * Seg.BATCH])
        print("[%s] peak device memory of the phase %.2f GB" % (tag, torch.cuda.max_memory_allocated() / 1e9))

    Config.gemmAlgo = Config.convAlgo = "hopper"
    del run, net
    torch.cuda.empty_cache()
    return launches, _convKernels(torch, winograd, tag, kernelConvs, Seg.BATCH, perShape=True)


class _NetGemms:
    """The launch counts of a net whose one hand kernel is K1: ``counted(fn)``
    runs ``fn`` with every counter at 0 and returns (its result, the K2, K2
    bwd-data, K3 and K1 counts); ``expect`` fails unless those are ``steps``
    forwards through each Linear of ``linears`` ({name: (K1 launches, of
    them on wgmma) a forward}, ``alexnetslice.linearLaunches``), counted
    from the net and inside each Linear, and no other hand kernel.  Inside
    ``with``, the per-Linear counts sit in ``fused.COUNTERS``, so that a
    fused replay adds to them."""

    def __init__(self, tag, matmul, net, linears):
        self.tag, self.linears = tag, linears
        self.layers = _LinearLaunches(matmul, net, list(linears))

    def __enter__(self):
        self.layers.__enter__()
        return self

    def __exit__(self, *exc):
        self.layers.__exit__(*exc)

    def counted(self, fn):
        self.layers.reset()
        _resetCounters()
        result = fn()
        counts = _readCounters()
        return result, {key: counts[key] for key in _SliceLaunches.KEYS}

    def expect(self, what, counts, steps, backward=0):
        want = dict.fromkeys(_SliceLaunches.KEYS, 0)
        want.update(matmul=steps * sum(n for n, _ in self.linears.values()),
                    matmulWgmma=steps * sum(w for _, w in self.linears.values()))
        wantTable = {name: (steps * n, steps * w) for name, (n, w) in self.linears.items()}

        print("[%s] %s launches: %s; K1 by Linear (all, on wgmma) %s" % (self.tag, what, counts, self.layers.table()))
        if counts != want or self.layers.table() != wantTable:
            fail("[%s] %s: expected launches %s, K1 by Linear %s; got %s, %s" %
                 (self.tag, what, want, wantTable, counts, self.layers.table()))


def phaseClassifier(torch, card, tag, NetSlice, dtype, bound):
    """AlexNet ([alexnet], ``tools/alexnetslice.py``, f32) or C3D ([c3d],
    ``tools/c3dslice.py``, bf16) at full width, He weights from
    ``np.random.seed(0)``.  Serving: 4 requests through ``Calculator``; on
    the first, the scores on the hand route within ``bound`` relative L2 of
    the same f32 weights on the library route (TF32 off).  Training:
    ``CrossEntropy`` and ``MomentumSGD(LEARN_RATE, 0.9)`` in global state, 4
    steps on the hand and the library routes, the losses within ``bound``
    of the library's and falling at each step on both; the hand route twice,
    the same bits.  Fused: ``_fusedAgainstEager`` (the first loss bit-equal
    to eager's, the rest within 5e-2, twice the same bits, one recording),
    ``FusedValidator`` equal to ``Validator``, ``FusedCalculator`` equal to
    ``Calculator``.  Launches, counted from the net
    (``alexnetslice.linearLaunches``) and inside each Linear: one K1 a
    request and a step on each of the three Linears, none on the library
    route; the eager and fused training ones also by the profiler.  Then
    images/s of each route (5 runs in turns), the idle share of 2 profiled
    steps and K1 at the three Linears' shapes against cuBLAS.  Returns the
    launches and the JSON entry's numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops.hopper import matmul

    Config.device = "cuda"
    Config.globalEvalMode = False
    torch.cuda.reset_peak_memory_stats()
    parts, start = {}, time.perf_counter()

    def part(name):
        nonlocal start
        parts[name] = time.perf_counter() - start
        start = time.perf_counter()

    net = NetSlice.build(torch.float32)
    images, labels = NetSlice.data(NetSlice.BATCH * NetSlice.STEPS)
    requests = images[:NetSlice.BATCH * REQUESTS]
    first = torch.from_numpy(requests[:NetSlice.BATCH]).cuda()

    # the f32 reference of serving: the same weights on the library route
    # (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    ref = net(first).float().clone()
    net.reset()
    net.trainMode()

    if dtype != torch.float32:
        net.calcMode(dtype)
    run = NetSlice.buildRun(net)
    linears = Alex.linearLaunches(net, NetSlice.BATCH, torch.cuda.get_device_properties(0).multi_processor_count)
    part("build and the f32 reference")
    print("[%s] %s %s at batch %d on %s inputs, %d parameters; K1 a forward on %s (all, on wgmma); "
          "MomentumSGD(%g, %g), CrossEntropy" %
          (tag, net.name, str(dtype).split(".")[-1], NetSlice.BATCH, "x".join(map(str, NetSlice.SHAPE)),
           net.numOfParams(), linears, NetSlice.LEARN_RATE, NetSlice.MOM_RATE))

    launches = {}
    with _NetGemms(tag, matmul, net, linears) as counter:
        for algo in ("torch", "hopper", "fused"):
            run.serve(algo, requests)
            (out, secs), counts = counter.counted(lambda: run.serve(algo, requests))
            launches["serving", algo] = counts
            counter.expect("serving on the %s, %d requests of %d" % (SLICE_ROUTES[algo], REQUESTS, NetSlice.BATCH),
                           counts, REQUESTS if algo != "torch" else 0)
            if out.shape != (len(requests), NetSlice.CLASSES) or not np.isfinite(out).all():
                fail("[%s] outputs of shape %s, finite: %s" % (tag, out.shape, np.isfinite(out).all()))
            launches["out", algo] = out

        same = np.array_equal(launches["out", "fused"], launches["out", "hopper"])
        handRel = _relL2(torch.from_numpy(launches["out", "hopper"][:NetSlice.BATCH]).cuda(), ref)
        libRel = _relL2(torch.from_numpy(launches["out", "torch"][:NetSlice.BATCH]).cuda(), ref)
        print("[%s] serving %d images: the first request's scores against the same f32 weights on the library "
              "route, relative L2: hand %.3e, library %.3e (bound %.0e); FusedCalculator bit-equal to Calculator %s; "
              "recordings %d" % (tag, len(requests), handRel, libRel, bound, same, run.fusedCalculator._program.captures))
        if not (handRel <= bound and same and run.fusedCalculator._program.captures == 1):
            fail("[%s] the scores %.3e from the f32 library run, fused equal to eager %s" % (tag, handRel, same))
        for key in [key for key in launches if key[0] == "out"]:
            del launches[key]
        del ref
        part("serving")

        # eager training, hand and library routes
        for algo in ("torch", "hopper"):
            run.train(algo, images, labels)

        losses, libLosses = [], []
        secs, launches["training"] = counter.counted(lambda: run.train("hopper", images, labels, losses))
        counter.expect("training, %d steps of %d" % (NetSlice.STEPS, NetSlice.BATCH), launches["training"], NetSlice.STEPS)
        print("[%s] training: %d images in %d steps, %.4f s" % (tag, len(images), NetSlice.STEPS, secs))
        _sameBitsAgain(tag, torch, run, "hopper", images, labels, losses, "eager hand route")

        run.train("torch", images, labels, libLosses)
        _lossesAgainst(tag, losses, libLosses, bound)
        for route, seen in (("hand", losses), ("library", libLosses)):
            if not all(later < earlier for earlier, later in zip(seen, seen[1:])):
                fail("[%s] the %s route's loss did not fall at every step at a learning rate of %g: %s" %
                     (tag, route, NetSlice.LEARN_RATE, seen))

        part("training")

        # the fused forms
        _fusedAgainstEager(tag, torch, run, counter, launches, images, labels, losses, requests,
                           labels[:len(requests)])
        part("fused")

        # rates and idle shares
        _routeRates(tag, card, {"training": (len(images), lambda algo: run.train(algo, images, labels)),
                                "serving": (len(requests), lambda algo: run.serve(algo, requests)[1])})
        part("rates")
        _idleShares(tag, run, images[:2 * NetSlice.BATCH], labels[:2 * NetSlice.BATCH])
        part("idle shares")
        print("[%s] peak device memory of the phase %.2f GB" % (tag, torch.cuda.max_memory_allocated() / 1e9))

    Config.gemmAlgo = Config.convAlgo = "hopper"
    shapes = [(name, mod.W.shape[0], mod.W.shape[1]) for name in linears for mod in net.modules()
              if mod.name == name]
    del run, net
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(11)
    main = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    dtName = "f32" if dtype == torch.float32 else "bf16"
    for name, k, n in shapes:
        _addCase(main, binding, _gemmCase(torch, matmul, gen, "%s-%s" % (tag, name), dtName, NetSlice.BATCH, k, n))
    main["bound_by"] = "/".join(sorted(binding))
    del main["wmma_ms"]
    part("K1 against cuBLAS")
    print("[time] [%s] by part: %s" % (tag, ", ".join("%s %.1f s" % item for item in parts.items())))
    return launches, main


def phaseLayers(torch):
    """The modules of ``tools/layerslice.py`` one by one at [layers]' shapes,
    in each type the module takes: each forward and backward on the card and
    on the CPU on the same inputs, then once more on the card.  A module
    that only moves data must give the CPU's bits, the others the twins'
    tiers (1e-5 of max(1, max |CPU|) in f32, 5e-2 in bf16); the second card
    run the first's bits.  Prints the seconds of the cases by module."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.tools import layerslice as Layers

    tag = "layers"
    seconds, feed, feedKey = {}, None, None
    for name, case in Layers.CASES.items():
        # cases of the same inputs sit side by side in CASES: they share
        # their host inputs and output gradients
        shapes = Layers.FULL[name]
        if Layers.feedKey(name, shapes) != feedKey:
            feed, feedKey = {}, Layers.feedKey(name, shapes)
        for dtype in case.dtypes:
            start = time.perf_counter()
            cpu = Layers.run(name, shapes, dtype, "cpu", feed=feed)
            card = Layers.run(name, shapes, dtype, "cuda", feed=feed)
            rows, ok = Layers.held(name, card, cpu, dtype)
            again = Layers.run(name, shapes, dtype, "cuda", feed=feed)
            repeats = all(same for _, same, _ in Layers.held(name, again, card, dtype)[0])
            secs = time.perf_counter() - start
            module = name.split()[0]
            seconds[module] = seconds.get(module, 0.0) + secs

            print("[%s] %-28s %-4s at %s: %s against the CPU: %s; again the same bits %s; %.1f s" %
                  (tag, name, dtype, " ".join("x".join(map(str, shape)) for shape in shapes),
                   "bit-equal" if case.exact else "within %.0e" % Layers.BOUNDS[dtype],
                   ", ".join("%s %s %.2e" % (what, "equal" if same else "differs", err) for what, same, err in rows),
                   repeats, secs))
            if not ok or not repeats:
                fail("[%s] %s in %s: card against CPU %s, repeat %s" % (tag, name, dtype, rows, repeats))

            del cpu, card, again
        torch.cuda.empty_cache()

    print("[time] [layers] by module: %s" % ", ".join("%s %.1f s" % item for item in seconds.items()))
    Config.device = "cuda"


# -- the MoE, graph-pass, RBM and VGG average-pool slice ------------------------------------------

# [moe]: the MoE trunk's step losses and scores on the hand route against
# the library route's, fused against eager and global state against local:
# f32 products that differ in summation order only
MOE_BOUND = 1e-4

# [rbm]: the f64 reference's units take the card's where the draw lies this
# close to the unit's probability (an f32 pre-activation cannot tell there)
RBM_TIE = 1e-6
RBM_BOUND = 1e-5


def phaseMoE(torch, card):
    """The MoE trunk of ``testlib/pipelinemoe.py`` (``tools/moeslice.py``)
    at full width in f32: a ``Pipeline`` of 4 ``Graph`` stages of Linear,
    tanh and a residual ``SwitchMoE`` of 4 Linear experts (capacity factor
    2), a ``Slice`` of 10 logits, ``CrossEntropy`` and ``MomentumSGD(0.05,
    0.9)`` in local state, batch 128 on seeded rows of the digits' shape.
    Serving: 4 requests through ``Calculator`` on the hand and library
    routes and ``FusedCalculator``; training: 4 steps through ``Trainer`` on
    both routes and ``FusedTrainer``.  K1 once a forward inside each of the
    20 Linears (4 trunk products of (128, 64) x (64, 64), 16 expert
    products of (64, 64) x (64, 64)), counted from the net, inside each
    Linear and by the profiler, none on the library route; the hand route's
    scores and losses within 1e-4 of the library's, the hand run twice the
    same bits, the fused losses within 1e-4 of eager's (the first
    bit-equal), the fused scores and validation error eager's.
    ``functionalize(stage 0)`` applied with each stage's parameter list
    gives that stage's eager output bit for bit; one run under global state
    gives the local run's losses.  Then rows/s of each route, the idle
    share of 2 profiled steps and K1 at the two shapes against cuBLAS.
    Returns the launches and the JSON entry's numbers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.fused import functionalize, paramList
    from puzzlelib_tpu_torch.modules import SwitchMoE
    from puzzlelib_tpu_torch.ops.hopper import matmul
    from puzzlelib_tpu_torch.tools import moeslice as Moe

    tag = "moe"
    Config.device = "cuda"
    Config.globalEvalMode = False
    Config.gemmAlgo = Config.convAlgo = "hopper"
    parts, start = {}, time.perf_counter()

    def part(name):
        nonlocal start
        parts[name] = time.perf_counter() - start
        start = time.perf_counter()

    rows, labels, valRows, valLabels = Moe.data()
    images, labels = rows[:Moe.BATCH * Moe.STEPS], labels[:Moe.BATCH * Moe.STEPS]
    requests = rows[:Moe.BATCH * REQUESTS]

    run = Moe.buildRun()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    linears = Moe.linearLaunches(run.net, Moe.BATCH, sms)
    capacities = [moe._capacity(Moe.BATCH) for moe in run.net.getAllByType(SwitchMoE)]
    print("[%s] %s f32 at batch %d on %d-feature rows, %d parameters, %d stages of %d experts (capacity %s rows); "
          "K1 a forward on %d Linears, none on wgmma; MomentumSGD(%g, %g) in local state, CrossEntropy" %
          (tag, run.net.name, Moe.BATCH, Moe.DIM, run.net.numOfParams(), Moe.STAGES, Moe.EXPERTS, capacities,
           len(linears), Moe.LEARN_RATE, Moe.MOM_RATE))
    if len(linears) != 20 or capacities != [64] * Moe.STAGES:
        fail("[%s] expected 20 Linears and capacities of 64, got %d and %s" % (tag, len(linears), capacities))
    part("build")

    launches, outs = {}, {}
    with _NetGemms(tag, matmul, run.net, linears) as counter:
        for algo in ("torch", "hopper", "fused"):
            run.serve(algo, requests)
            (out, secs), counts = counter.counted(lambda: run.serve(algo, requests))
            launches["serving", algo] = counts
            counter.expect("serving on the %s, %d requests of %d" % (SLICE_ROUTES[algo], REQUESTS, Moe.BATCH),
                           counts, REQUESTS if algo != "torch" else 0)
            if out.shape != (len(requests), Moe.CLASSES) or not np.isfinite(out).all():
                fail("[%s] scores of shape %s, finite: %s" % (tag, out.shape, np.isfinite(out).all()))
            outs[algo] = out

        scoreErr = np.abs(outs["hopper"] - outs["torch"]).max() / np.abs(outs["torch"]).max()
        same = np.array_equal(outs["fused"], outs["hopper"])
        print("[%s] serving %d rows: scores on the hand route against the library route's, max |diff| / max |lib| "
              "%.3e (bound %.0e); FusedCalculator bit-equal to Calculator %s; recordings %d" %
              (tag, len(requests), scoreErr, MOE_BOUND, same, run.fusedCalculator._program.captures))
        if not (scoreErr <= MOE_BOUND and same and run.fusedCalculator._program.captures == 1):
            fail("[%s] scores %.3e from the library route's, fused equal to eager %s" % (tag, scoreErr, same))
        part("serving")

        for algo in ("torch", "hopper"):
            run.train(algo, images, labels)

        losses, libLosses = [], []
        secs, launches["training"] = counter.counted(lambda: run.train("hopper", images, labels, losses))
        counter.expect("training, %d steps of %d" % (Moe.STEPS, Moe.BATCH), launches["training"], Moe.STEPS)
        print("[%s] training: %d rows in %d steps, %.4f s" % (tag, len(images), Moe.STEPS, secs))
        _sameBitsAgain(tag, torch, run, "hopper", images, labels, losses, "eager hand route")
        run.train("torch", images, labels, libLosses)
        _lossesAgainst(tag, losses, libLosses, MOE_BOUND)
        part("training")

        _fusedAgainstEager(tag, torch, run, counter, launches, images, labels, losses, valRows, valLabels,
                           bound=MOE_BOUND)
        part("fused")

        _routeRates(tag, card, {"training": (len(images), lambda algo: run.train(algo, images, labels)),
                                "serving": (len(requests), lambda algo: run.serve(algo, requests)[1])}, unit="rows")
        part("rates")
        _idleShares(tag, run, images[:2 * Moe.BATCH], labels[:2 * Moe.BATCH])
        part("idle shares")

    # the single-device half of the testlib's "eager == mesh schedule"
    # check: stage 0 as a function of each stage's weights
    Config.gemmAlgo = "hopper"
    pipe = run.net.graph[0]
    apply, _ = functionalize(pipe.graph[0])
    pairs = Moe.stageOutputs(run.net, torch.from_numpy(requests[:Moe.BATCH]).cuda())
    same = [torch.equal(apply(paramList(stage), inp), out) for stage, (inp, out) in zip(pipe.graph, pairs)]
    print("[%s] functionalize(stage 0) with each stage's parameter list, against that stage's eager output: "
          "bit-equal %s" % (tag, same))
    if not all(same):
        fail("[%s] functionalize gave other bits than the stages' eager forwards: %s" % (tag, same))

    # global state: the flat buffer's views feed the experts
    globalRun = Moe.buildRun(Moe.buildNet(), globalState=True)
    globalLosses = []
    globalRun.train("hopper", images, labels, globalLosses)
    rel = max(abs(a - b) / abs(b) for a, b in zip(globalLosses, losses))
    print("[%s] under global state (one flat buffer of %d values): losses %s, against local state's largest "
          "relative difference %.3e (bound %.0e), bit-equal %s" %
          (tag, globalRun.optimizer.shParams[torch.float32].ary.numel(), " ".join("%.6f" % v for v in globalLosses),
           rel, MOE_BOUND, globalLosses == losses))
    if not rel <= MOE_BOUND:
        fail("[%s] global state's losses %s against local state's %s" % (tag, globalLosses, losses))
    part("functionalize and global state")

    del run, globalRun
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(12)
    main = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    for label, m, count in (("moe-trunk", Moe.BATCH, Moe.STAGES), ("moe-expert", 64, Moe.STAGES * Moe.EXPERTS)):
        _addCase(main, binding, _gemmCase(torch, matmul, gen, label, "f32", m, Moe.DIM, Moe.DIM), count)
    main["bound_by"] = "/".join(sorted(binding))
    del main["wmma_ms"]
    part("K1 against cuBLAS")
    print("[time] [%s] by part: %s" % (tag, ", ".join("%s %.1f s" % item for item in parts.items())))
    return launches, main


def phaseGraphPass(torch, card):
    """``passes.toGraph`` of ResNet-50 (``tools/resnetslice.py``: bf16 at
    batch 32, He weights from ``np.random.seed(0)``, without its SoftMax,
    ``MomentumSGD(0.01, 0.9)`` in global state): the Sequential and its
    graph, built from the same seed, each serve 4 requests and train 4
    steps on the hand route.  Each must launch what the Sequential launches
    (one K2 a request and one K2, K2-bwd and K3 a step inside each of the 13
    Winograd convs, one K1, on wgmma); the graph's scores must be the
    Sequential's bit for bit and its losses within 5e-2.  Returns the
    graph's launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.ops.hopper import winograd
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.passes import toGraph

    tag = "graph-pass"
    Config.device = "cuda"
    Config.gemmAlgo = Config.convAlgo = "hopper"

    seqRun = Res.buildRun()
    convs = Res.winogradConvs(seqRun.net, (Res.BATCH, ) + Res.SHAPE)

    net = Res.build()
    net.pop()
    graph = toGraph(net)
    graph.calcMode(torch.bfloat16)
    optimizer = MomentumSGD(Res.LEARN_RATE, momRate=Res.MOM_RATE)
    optimizer.setupOn(graph, useGlobalState=True)
    graphRun = Res.Run(graph, optimizer, CrossEntropy(maxlabels=Res.CLASSES), Res.BATCH)
    print("[%s] ResNet-50 as a Sequential of %d modules and as toGraph's Graph of %d nodes (%d parameters each); "
          "%d Winograd convs" % (tag, len(seqRun.net.graph), len(graph.nodes), graph.numOfParams(), len(convs)))

    images, labels = Res.data(Res.BATCH * REQUESTS)
    launches, outs, losses = {}, {}, {}
    for name, run in (("sequential", seqRun), ("graph", graphRun)):
        with _SliceLaunches("%s] [%s" % (tag, name), winograd, run.net, convs, 1) as counter:
            run.serve("hopper", images)
            (outs[name], _), counts = counter.counted(lambda: run.serve("hopper", images))
            counter.expect("serving, %d requests of %d" % (REQUESTS, Res.BATCH), counts, REQUESTS, 0)
            launches[name, "serving"] = counts

            run.train("hopper", images, labels)
            losses[name] = []
            _, counts = counter.counted(lambda: run.train("hopper", images, labels, losses[name]))
            counter.expect("training, %d steps of %d" % (REQUESTS, Res.BATCH), counts, REQUESTS, 1)
            launches[name, "training"] = counts

    same = np.array_equal(outs["graph"], outs["sequential"])
    print("[%s] the graph's scores of %d images bit-equal to the Sequential's: %s; launches equal: serving %s, "
          "training %s" % (tag, len(images), same, launches["graph", "serving"] == launches["sequential", "serving"],
                           launches["graph", "training"] == launches["sequential", "training"]))
    if not same or not np.isfinite(outs["graph"]).all():
        fail("[%s] the graph's scores differ from the Sequential's" % tag)
    _lossesAgainst(tag, losses["graph"], losses["sequential"], TRAIN_BOUND, ref="Sequential")
    print("[%s] graph losses bit-equal to the Sequential's: %s" % (tag, losses["graph"] == losses["sequential"]))

    del seqRun, graphRun, net, graph
    torch.cuda.empty_cache()
    return {"serving": launches["graph", "serving"], "training": launches["graph", "training"]}


class _RecordedDraws:
    """A stand-in ``rng`` that keeps a copy of every uniform draw of the
    generator it wraps."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def fillUniform(self, data, minval=0.0, maxval=1.0):
        self.rng.fillUniform(data, minval, maxval)
        self.draws.append(data.clone())


def phaseRBM(torch, card):
    """``RBM(784, 500)`` in f32 (``tools/rbmslice.py``) at batch 128 on
    seeded binary rows of 10 prototypes: 20 CD-1 steps and 20 PCD steps of
    ``MomentumSGD``; the reconstruction error must fall (under CD-1 below
    half its start), and a second run from the same generator seed give the
    same bits.  One CD-1 gradient against an f64 numpy Gibbs step on the
    uniforms the card drew, within 1e-5 (a unit whose draw lies within 1e-6
    of its probability takes the card's value, counted).  Rows/s of each."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.tools import rbmslice as Rbm

    tag = "rbm"
    Config.device = "cuda"
    Config.globalEvalMode = False
    rows = torch.from_numpy(Rbm.data()).cuda()
    print("[%s] RBM(%d, %d) f32 at batch %d on binary rows of %d prototypes (%.0f %% of the pixels flipped); "
          "MomentumSGD(%g, %g), %d steps" % (tag, Rbm.VSIZE, Rbm.HSIZE, Rbm.BATCH, Rbm.PROTOTYPES, 100 * Rbm.FLIP,
                                             Rbm.LEARN_RATE, Rbm.MOM_RATE, Rbm.STEPS))

    for persistent, name in ((False, "CD-1"), (True, "PCD")):
        Rbm.train(rows, persistent, steps=2)
        errors = []
        Rbm.train(rows, persistent, errors=errors)
        synchronize()
        start = time.perf_counter()
        rbm = Rbm.train(rows, persistent)
        synchronize()
        secs = time.perf_counter() - start
        again = Rbm.train(rows, persistent)
        same = all(torch.equal(a.data, b.data) for a, b in zip(rbm.vars.values(), again.vars.values()))
        if persistent:
            same = same and torch.equal(rbm.particles, again.particles)

        falls = errors[-1] < errors[0] * (0.5 if not persistent else 1.0)
        print("[%s] %s: reconstruction error %s over %d steps; falls %s; a second run bit-equal %s; %.4f s, %.0f "
              "rows/s on %s" % (tag, name, " -> ".join("%.4f" % e for e in errors[::5] + errors[-1:]), Rbm.STEPS,
                                falls, same, secs, Rbm.STEPS * Rbm.BATCH / secs, card))
        if not falls or not same:
            fail("[%s] %s: error %s, repeat %s" % (tag, name, errors, same))

    rbm = Rbm.build()
    rbm.rng = _RecordedDraws(rbm.rng)
    units = rbm.calcCDGrad(rows)
    u = [draw.double().cpu().numpy() for draw in rbm.rng.draws]
    got = [unit.double().cpu().numpy() for unit in units]
    W, b, c = (var.data.double().cpu().numpy() for var in rbm.vars.values())
    x = rows.double().cpu().numpy()

    ties, ref = 0, []
    for draw, card_, pre in ((u[0], got[0], lambda: x @ W + c), (u[1], got[1], lambda: ref[0] @ W.T + b),
                             (u[2], got[2], lambda: ref[1] @ W + c)):
        prob = 1.0 / (1.0 + np.exp(-pre()))
        tie = np.abs(draw - prob) < RBM_TIE
        ties += int(tie.sum())
        ref.append(np.where(tie, card_, (draw < prob).astype(np.float64)))

    want = {"W": x.T @ ref[0] - ref[1].T @ ref[2], "b": x.sum(0) - ref[1].sum(0), "c": ref[0].sum(0) - ref[2].sum(0)}
    errs = {name: np.abs(rbm.vars[name].grad.double().cpu().numpy() - w).max() / max(1.0, np.abs(w).max())
            for name, w in want.items()}
    unitsEqual = all(np.array_equal(g, r) for g, r in zip(got, ref))
    print("[%s] calcCDGrad against an f64 numpy Gibbs step on the card's draws: max |diff| / max(1, |ref|) %s "
          "(bound %.0e); units equal %s; units within %.0e of their probability %d of %d" %
          (tag, ", ".join("%s %.3e" % item for item in errs.items()), RBM_BOUND, unitsEqual, RBM_TIE, ties,
           sum(d.size for d in u)))
    if not (max(errs.values()) <= RBM_BOUND and unitsEqual):
        fail("[%s] calcCDGrad against the f64 reference: %s, units equal %s" % (tag, errs, unitsEqual))


def phaseVggAverage(torch, card):
    """``loadVGG(None, "16", poolmode="avg")`` in bf16, He weights from
    ``np.random.seed(0)``: 4 requests of 32 through ``Calculator`` on the
    hand and library routes; one K2 a request on each of the 10 Winograd
    convs (counted inside each conv), three K1 on wgmma; the outputs of
    all requests and fc8 of the first within 5e-2 relative L2 of the
    library route's.  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.ops.hopper import winograd

    tag = "vgg-avg"
    Config.device = "cuda"
    Config.globalEvalMode = True   # no gradient buffers for a serving net

    np.random.seed(0)
    net = loadVGG(None, "16", poolmode="avg", initscheme="he")
    net.calcMode(torch.bfloat16)
    net.evalMode()
    Config.globalEvalMode = False   # the phases after this one train
    served = Res.Served(net, BATCH)
    convs = Res.winogradConvs(net, (BATCH, 3, 224, 224))
    images = np.random.RandomState(1).randn(BATCH * REQUESTS, 3, 224, 224).astype(np.float32)

    with _SliceLaunches(tag, winograd, net, convs, 3) as counter:
        for algo in ("torch", "hopper"):
            served.serve(algo, images)
        (out, secs), counts = counter.counted(lambda: served.serve("hopper", images))
        counter.expect("serving, %d requests of %d" % (REQUESTS, BATCH), counts, REQUESTS, 0)
    libOut, libSecs = served.serve("torch", images)

    fc8 = {}
    for algo in ("hopper", "torch"):
        Config.gemmAlgo = Config.convAlgo = algo
        net(torch.from_numpy(images[:BATCH]).cuda().to(torch.bfloat16))
        fc8[algo] = net["fc8"].data.float().clone()
        net.reset()
    Config.gemmAlgo = Config.convAlgo = "hopper"

    rel = float(np.linalg.norm(out - libOut) / np.linalg.norm(libOut))
    relFc8 = ((fc8["hopper"] - fc8["torch"]).norm() / fc8["torch"].norm()).item()
    print("[%s] VGG-16 with average pooling, bf16, %d images in %d requests of %d: %.4f s (%.1f images/s), library "
          "route %.4f s, on %s; outputs against the library route's, relative L2 %.3e, fc8 of the first request "
          "%.3e (bound %.0e)" % (tag, len(images), REQUESTS, BATCH, secs, len(images) / secs, libSecs, card, rel,
                                 relFc8, SLICE_BOUND))
    if out.shape != (len(images), 1000) or not np.isfinite(out).all() or not (rel <= SLICE_BOUND and
                                                                              relFc8 <= SLICE_BOUND):
        fail("[%s] outputs %s, relative L2 %.3e and fc8 %.3e from the library route's" % (tag, out.shape, rel, relFc8))

    del net, served
    torch.cuda.empty_cache()
    return counts


# -- the measured per-shape dispatch ----------------------------------------------------------------

# the gap past which a second race must repeat the first's choice
AUTO_REPEAT_GAP = 0.10

# the races of [auto] beyond VGG-16's and U-Net's: AlexNet's fc6-fc8 in f32
# at batch 128 and the MoE trunk's products in f32 ((in, out), rows), and
# the attention cores (batch, seq, emb, heads): the transformer slice's and
# a long one
AUTO_LINEARS = [("alexnet-fc6", 9216, 4096, 128), ("alexnet-fc7", 4096, 4096, 128),
                ("alexnet-fc8", 4096, 1000, 128), ("moe-trunk", 64, 64, 128), ("moe-expert", 64, 64, 64)]
AUTO_ATTENTION = [("transformer", 64, 80, 128, 4), ("long", 4, 2048, 512, 8)]


class _RaceLog:
    """Inside ``with``, every call of the three races (``measureAlgoChoice``,
    ``tuneDispatch``, ``measureAttnChoice``) is logged by name and
    arguments, so that ``again`` can run the same races once more."""

    def __init__(self):
        from puzzlelib_tpu_torch.ops import attention, conv
        from puzzlelib_tpu_torch.ops.hopper import matmul

        self.targets = [(conv, "measureAlgoChoice"), (matmul, "tuneDispatch"), (attention, "measureAttnChoice")]
        self.calls = []

    def __enter__(self):
        self.saved = [getattr(owner, name) for owner, name in self.targets]
        for (owner, name), fn in zip(self.targets, self.saved):
            setattr(owner, name, self._logged(fn))
        return self

    def _logged(self, fn):
        def logged(*args, **kwargs):
            self.calls.append((fn, args, kwargs))
            return fn(*args, **kwargs)
        return logged

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self.targets, self.saved):
            setattr(owner, name, fn)

    def again(self):
        for fn, args, kwargs in self.calls:
            fn(*args, **kwargs)


def _raceTables():
    """{("conv" | "gemm" | "attention", key): (choice, hand ms, library ms)}
    of the three measured tables."""
    from puzzlelib_tpu_torch.ops import attention, conv
    from puzzlelib_tpu_torch.ops.hopper import matmul

    table = {}
    for kind, choices, times in (("conv", conv._algoChoice, conv._algoMs), ("gemm", matmul._dispatch, matmul._raceMs),
                                 ("attention", attention._attnChoice, attention._attnMs)):
        for key, choice in choices.items():
            table[kind, key] = (choice, ) + tuple(times[key])
    return table


def _followsRule(kind, choice, handMs, libMs):
    from puzzlelib_tpu_torch.ops import conv

    margin = 1.0 if kind == "gemm" else conv.MARGIN
    hand = handMs < margin * libMs
    return choice == {"conv": ("hopper", "torch"), "gemm": ("hopper", "torch"),
                      "attention": ("flash", "xla")}[kind][0 if hand else 1]


def _convKeys(net, inshape):
    """[(direction, ``ops.conv._algoChoice`` key)] of every conv of ``net``
    that a hand kernel takes, for an input of ``inshape``."""
    from puzzlelib_tpu_torch.ops import conv
    from puzzlelib_tpu_torch.tools import resnetslice as Res

    return [item for mod, shape in Res.convInputs(net, inshape)
            for item in conv.raceKeys(shape, tuple(mod.W.shape), mod.stride, mod.pad, mod.dilation,
                                      mod.groups).items()]


def _autoCounts(net, inshape, steps, backward):
    """The launches "auto" must make in ``steps`` batches of ``inshape``
    through ``net`` (forward only, or with ``backward``), from the measured
    tables: K2 on each conv whose forward was recorded "hopper" (and K2 as
    bwd-data, K3, on each whose bwd-data, bwd-filter was), K1 on each Linear
    whose product was."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.modules import Linear
    from puzzlelib_tpu_torch.ops import conv
    from puzzlelib_tpu_torch.ops.hopper import matmul

    hand = {"fwd": 0, "bwdData": 0, "fg": 0}
    for direction, key in _convKeys(net, inshape):
        hand[direction] += Config.route("auto", conv._algoChoice, key)

    linears = sum(Config.route("auto", matmul._dispatch, matmul.dispatchKey(inshape[0], lin.W.shape[1],
                                                                               lin.W.shape[0], lin.calctype))
                  for lin in net.getAllByType(Linear))

    return {"winograd": steps * (hand["fwd"] + backward * hand["bwdData"]),
            "winogradDataGrad": steps * backward * hand["bwdData"], "winogradFG": steps * backward * hand["fg"],
            "matmul": steps * linears}


def _autoCounted(tag, what, fn, want):
    _resetCounters()
    result = fn()
    counts = _readCounters()
    seen = {key: counts[key] for key in want}
    print("[%s] %s launches %s (from the table: %s)" % (tag, what, seen, want))
    if seen != want:
        fail("[%s] %s: launches %s, the table asks for %s" % (tag, what, seen, want))
    return result


def _autoNet(torch, card, tag, run, inshape, images, labels, requests):
    """One slice under "auto" after its race: serving and training eager
    and fused, each kernel's launches those the table asks for, the scores
    and losses within 5e-2 of the library route's; a forced table change
    that the fused trainer records anew; rates of the hand, library and
    auto routes in 5 runs in turns."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops import conv

    batch = inshape[0]
    serveWant = _autoCounts(run.net, inshape, len(requests) // batch, 0)
    trainWant = _autoCounts(run.net, inshape, len(images) // batch, 1)

    run.serve("fused-auto", requests)   # the recordings, outside the counted runs
    run.train("fused-auto", images, labels)

    libScores, _ = run.serve("torch", requests)
    libLosses = []
    run.train("torch", images, labels, libLosses)

    for algo in ("auto", "fused-auto"):
        scores, _ = _autoCounted(tag, "%s serving, %d requests of %d" % (algo, len(requests) // batch, batch),
                                 lambda: run.serve(algo, requests), serveWant)
        losses = []
        _autoCounted(tag, "%s training, %d steps of %d" % (algo, len(images) // batch, batch),
                     lambda: run.train(algo, images, labels, losses), trainWant)

        rel = float(np.linalg.norm(scores - libScores) / np.linalg.norm(libScores))
        print("[%s] %s: scores against the library route's relative L2 %.3e (bound %.0e), finite %s" %
              (tag, algo, rel, SLICE_BOUND, np.isfinite(scores).all()))
        if not (rel <= SLICE_BOUND and np.isfinite(scores).all()):
            fail("[%s] %s scores %.3e from the library route's" % (tag, algo, rel))
        _lossesAgainst("%s] [%s" % (tag, algo), losses, libLosses, TRAIN_BOUND)

    # a forced change of one conv's forward choice: the fused trainer records anew
    step = run.fusedTrainer.step
    before = step.captures
    key = next(key for direction, key in _convKeys(run.net, inshape) if direction == "fwd")
    old = conv._algoChoice[key]
    # a new recording follows one eager warm-up step, whose launches count too
    unchanged = _autoCounts(run.net, inshape, len(images) // batch + 1, 1)
    Config.recordChoice(conv._algoChoice, key, "torch" if old == "hopper" else "hopper")
    changed = _autoCounts(run.net, inshape, len(images) // batch + 1, 1)
    _autoCounted(tag, "fused-auto training after %s was forced from %s" % (key, old),
                 lambda: run.train("fused-auto", images, labels), changed)
    print("[%s] recordings of the fused step before the change %d, after %d" % (tag, before, step.captures))
    if step.captures != before + 1 or changed == unchanged:
        fail("[%s] the forced change gave recordings %d -> %d, launches %s" % (tag, before, step.captures, changed))
    Config.recordChoice(conv._algoChoice, key, old)

    routes = {"hopper": "hand kernels", "torch": "library route", "auto": "measured routes"}
    for what, count, fn in (("training", len(images), lambda algo: run.train(algo, images, labels)),
                            ("serving", len(requests), lambda algo: run.serve(algo, requests)[1])):
        secs = _turns({}, {algo: (lambda algo=algo: fn(algo)) for algo in routes})
        for algo, runs in secs.items():
            print("[%s] %s %s, 5 runs in turns: %s s, median %.1f images/s on %s" %
                  (tag, routes[algo], what, " ".join("%.4f" % t for t in runs), count / float(np.median(runs)), card))
    Config.gemmAlgo = Config.convAlgo = "hopper"


def _heOnCard(torch, net, seed):
    """He-normal weights for ``net``'s convs and Linears drawn on the card
    from ``seed`` (numpy's sampler takes seconds for VGG-16's 138 M), zero
    biases."""
    from puzzlelib_tpu_torch.modules import ConvND, Linear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for mod in net.getAllByType(ConvND) + net.getAllByType(Linear):
        fanIn = mod.W[0].numel() if isinstance(mod, ConvND) else mod.W.shape[0]
        mod.W.copy_(torch.randn(mod.W.shape, generator=gen, device="cuda") * (2.0 / fanIn) ** 0.5)
        if mod.b is not None:
            mod.b.zero_()


def phaseAuto(torch, card):
    """The measured per-shape dispatch (``Config.convAlgo = gemmAlgo =
    "auto"``).  The tables emptied, then the races through the entry points
    a user calls: ``optimizeForShape`` of VGG-16 bf16 at batch 32 (its 10
    Winograd convs, three directions each, and fc6-fc8) and of U-Net bf16 at
    batch 4 on 512^2 (15 convs), of AlexNet's fc6-fc8 in f32 at 128 and the
    MoE trunk's products (``AUTO_LINEARS``), and of the transformer's
    attention at its slice shape and at (4, 8, 2048, 64)
    (``AUTO_ATTENTION``).  One line a key: hand and library ms and the
    choice, which must follow those times under the rule (hand below 0.97x
    the library for convs and attention, strictly faster for a product).
    The same races again: the same choice wherever the first race's gap
    passed 10 %.  Then VGG-16 and U-Net each serve 4 requests and train 4
    steps under "auto", eager and fused (``_autoNet``), VGG-16's He weights
    drawn on the card (``_heOnCard``).  The races' own launches fall before
    the counted runs and are not counted."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.modules import Linear, MultiHeadAttention
    from puzzlelib_tpu_torch.ops import conv
    from puzzlelib_tpu_torch.tools import resnetslice as Res
    from puzzlelib_tpu_torch.tools import unetslice as Unet

    tag = "auto"
    Config.device = "cuda"
    Config.globalEvalMode = False
    Config.gemmAlgo = Config.convAlgo = "hopper"
    conv.resetDispatchCaches()

    parts, start = {}, time.perf_counter()
    vggNet = loadVGG(None, "16", initscheme="none")
    _heOnCard(torch, vggNet, 0)
    vgg = Res.buildRun(vggNet)
    vgg.optimizer.learnRate = LEARN_RATE
    unet = Unet.buildRun()
    vggShape, unetShape = (BATCH, 3, 224, 224), (Unet.BATCH, ) + Unet.SHAPE
    parts["build"] = time.perf_counter() - start

    start = time.perf_counter()
    with _RaceLog() as log:
        vgg.net.optimizeForShape(vggShape)
        unet.net.optimizeForShape(unetShape)
        for name, insize, outsize, rows in AUTO_LINEARS:
            Linear(insize, outsize, name=name).optimizeForShape((rows, insize))
        for name, batch, seq, emb, heads in AUTO_ATTENTION:
            attn = MultiHeadAttention(emb, heads, name=name)
            attn.calcMode(torch.bfloat16)
            attn.optimizeForShape((batch, seq, emb))
    parts["races"] = raceSecs = time.perf_counter() - start

    start = time.perf_counter()
    first = _raceTables()
    conv.resetDispatchCaches()
    log.again()
    second = _raceTables()
    parts["second race"] = time.perf_counter() - start

    print("[%s] %d races (%d calls of optimizeForShape's measure functions, their convs' three directions "
          "timed too) in %.1f s on %s" % (tag, len(first), len(log.calls), raceSecs, card))
    mismatched = []
    for (kind, key), (choice, handMs, libMs) in sorted(first.items(), key=lambda item: repr(item[0])):
        again = second.get((kind, key))
        gap = max(handMs, libMs) / min(handMs, libMs) - 1.0
        print("[%s] race %-9s %s: hand %.4f ms, library %.4f ms (%.2fx) -> %s; second race %s" %
              (tag, kind, key, handMs, libMs, handMs / libMs, choice,
               "%.4f / %.4f ms -> %s" % (again[1], again[2], again[0]) if again else "missing"))
        if not _followsRule(kind, choice, handMs, libMs) or again is None \
                or not _followsRule(kind, *again):
            mismatched.append((kind, key))
        elif gap > AUTO_REPEAT_GAP and again[0] != choice:
            mismatched.append((kind, key))

    if len(second) != len(first) or mismatched:
        fail("[%s] races off their rule or not repeated past a %.0f %% gap: %s" %
             (tag, 100 * AUTO_REPEAT_GAP, mismatched))

    hands = {kind: sum(choice in ("hopper", "flash") for (k, _), (choice, _, _) in first.items() if k == kind)
             for kind in ("conv", "gemm", "attention")}
    print("[%s] hand choices: conv directions %d, products %d, attention %d, of %d races" %
          (tag, hands["conv"], hands["gemm"], hands["attention"], len(first)))

    start = time.perf_counter()
    images, labels = Res.data(BATCH * STEPS)
    _autoNet(torch, card, "%s] [vgg16" % tag, vgg, vggShape, images, labels, images[:BATCH * REQUESTS])
    del vgg, images, labels
    torch.cuda.empty_cache()
    parts["VGG-16 under auto"] = time.perf_counter() - start

    start = time.perf_counter()
    images, masks = Unet.data(Unet.BATCH * STEPS)
    _autoNet(torch, card, "%s] [unet" % tag, unet, unetShape, images, masks, images[:Unet.BATCH * REQUESTS])
    del unet, images, masks
    parts["U-Net under auto"] = time.perf_counter() - start
    print("[time] [%s] by part: %s" % (tag, ", ".join("%s %.1f s" % item for item in parts.items())))

    conv.resetDispatchCaches()
    Config.gemmAlgo = Config.convAlgo = "hopper"
    torch.cuda.empty_cache()
    return first


def _dataRate(tag, what, count, secs, card, unit="rows"):
    print("[%s] %s: %d %s in %.4f s, %.1f %s/s on %s" % (tag, what, count, unit, secs, count / secs, unit, card))


def _dataParse(tag, card, path, raw):
    """MNIST's and CIFAR-10's parse steps on the files in ``path`` (``raw``
    what ``dataslice`` wrote), timed and held to ``dataslice``'s arrays,
    and IMDB's parse under DATA_SEEDS["imdb"]: (MNIST's arrays, CIFAR-10's,
    IMDB's (data, labels))."""
    from puzzlelib_tpu_torch.datasets import Cifar10Loader, MnistLoader
    from puzzlelib_tpu_torch.tools import dataslice as Data
    from puzzlelib_tpu_torch.testlib import rnnimdbtrain

    parsed, want = {}, {"mnist": Data.mnistArrays(*raw["mnist"]), "cifar": Data.cifarArrays(raw["cifar"])}
    for name, loader in (("mnist", MnistLoader()), ("cifar", Cifar10Loader())):
        start = time.perf_counter()
        parsed[name] = loader._parse(path, log=False)
        _dataRate(tag, "%s parsed on the host" % type(loader).__name__, len(parsed[name][0]),
                  time.perf_counter() - start, card)

        same = all(got.dtype == ref.dtype and np.array_equal(got, ref) for got, ref in zip(parsed[name], want[name]))
        print("[%s] %s: images %s %s, labels %s %s; equal to the computation from the written bytes, bit for bit: %s"
              % (tag, type(loader).__name__, parsed[name][0].shape, parsed[name][0].dtype, parsed[name][1].shape,
                 parsed[name][1].dtype, same))
        if not same:
            fail("[%s] %s's arrays differ from the bytes it read" % (tag, type(loader).__name__))

    data, labels, secs = Data.parseImdb(path, DATA_SEEDS["imdb"], rnnimdbtrain.NUMWORDS, rnnimdbtrain.MAXLEN)
    _dataRate(tag, "IMDBLoader(numwords=%d, maxlen=%d) parsed on the host (%d words)" %
              (rnnimdbtrain.NUMWORDS, rnnimdbtrain.MAXLEN, raw["imdbWords"]), len(data), secs, card)

    inRange = data.dtype == np.int32 and 0 <= data.min() and data.max() < rnnimdbtrain.NUMWORDS
    reviews = Data.IMDB_TRAIN + Data.IMDB_TEST
    print("[%s] IMDBLoader: data %s %s, ids in [%d, %d], labels %s %s" % (tag, data.shape, data.dtype, data.min(),
                                                                          data.max(), labels.shape, labels.dtype))
    if data.shape != (reviews, rnnimdbtrain.MAXLEN) or len(labels) != reviews or not inRange:
        fail("[%s] IMDB's parsed arrays: %s %s, ids %d to %d" % (tag, data.shape, data.dtype, data.min(), data.max()))

    try:
        import h5py  # noqa: F401
        h5 = "imports here"
    except ImportError:
        h5 = "does not import here"
    print("[%s] h5py %s; the loaders' HDF5 cache (load) is held by the CPU twins (tests/test_torch_datasets.py), "
          "this phase runs the parse steps" % (tag, h5))

    return parsed["mnist"], parsed["cifar"], (data, labels)


def _dataParsedAgain(tag, card, imdb, again):
    """Fail unless ``again`` (a second IMDB parse under the same seed, from
    another process) gave ``imdb``'s bits."""
    data, labels, secs = again.result()
    _dataRate(tag, "IMDBLoader, a second parse under the same seed in a process of its own, beside the card's work",
              len(data), secs, card)

    repeated = np.array_equal(data, imdb[0]) and np.array_equal(labels, imdb[1])
    print("[%s] IMDBLoader: the second parse bit-equal: %s" % (tag, repeated))
    if not repeated:
        fail("[%s] a second IMDB parse under the same seed gave other bits" % tag)


def _dataChunks(serial, count, chunk):
    """The ``count`` chunks of ``serial``, the next one prepared on its
    threads while the caller trains on the current one."""
    serial.prepareData(chunksize=chunk)
    for k in range(count):
        current = serial.getData()
        if k + 1 < count:
            serial.prepareData(chunksize=chunk)
        yield current


def _dataLeNet(torch, tag, card, images, labels):
    """LeNet on ``cnnmnistlenet``'s recipe over its ``TRAIN_SPLIT`` (60000)
    images, on the two routes from the same start, validated on the rest;
    returns K1's launches."""
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.ops.hopper import matmul
    from puzzlelib_tpu_torch.testlib import cnnmnistlenet
    from puzzlelib_tpu_torch.transformers import Serial, Transformer

    split = cnnmnistlenet.TRAIN_SPLIT
    train, trainLabels = images[:split], labels[:split]
    chunks = len(train) // DATA_CHUNK

    _, _, trainer, _ = cnnmnistlenet.buildTraining()
    rows = trainer.batchsize + DATA_CHUNK % trainer.batchsize
    trainer.trainFromHost(train[:rows], trainLabels[:rows], macroBatchSize=DATA_CHUNK)
    steps = chunks * -(-DATA_CHUNK // trainer.batchsize)

    def direct():
        for k in range(chunks):
            rows = slice(k * DATA_CHUNK, (k + 1) * DATA_CHUNK)
            yield train[rows], trainLabels[rows]

    def threaded():
        with Serial(train, trainLabels, numofthreads=DATA_THREADS) as serial:
            serial.addTransformer(Transformer())
            yield from _dataChunks(serial, chunks, DATA_CHUNK)

    losses, launches, errors = {}, {}, {}
    for route, feed in (("direct", direct), ("serial", threaded)):
        _, _, trainer, validator = cnnmnistlenet.buildTraining()
        losses[route] = []
        trainer.onBatchFinish = lambda h, out=losses[route]: out.append(h.cost.getError())

        np.random.seed(DATA_SEEDS["shuffle"])
        _resetCounters()
        synchronize()
        start = time.perf_counter()
        for chunk, chunkLabels in feed():
            trainer.trainFromHost(chunk, chunkLabels, macroBatchSize=DATA_CHUNK)
        synchronize()
        secs = time.perf_counter() - start
        launches[route] = matmul.launches

        _resetCounters()
        errors[route] = validator.validateFromHost(images[split:], labels[split:], macroBatchSize=DATA_CHUNK)
        launches[route + "Validate"] = matmul.launches

        what = {"direct": "chunks of %d straight into trainFromHost" % DATA_CHUNK,
                "serial": "chunks of %d through a %d-thread Serial (identity Transformer, the next chunk prepared "
                          "while the card trains)" % (DATA_CHUNK, DATA_THREADS)}[route]
        _dataRate(tag, "LeNet f32, MomentumSGD(%g, %g), one epoch of parsed MNIST in %s, %d steps" %
                  (cnnmnistlenet.LEARN_RATE, cnnmnistlenet.MOM_RATE, what, len(losses[route])), len(train), secs,
                  card, unit="images")
        print("[%s] LeNet, %s: K1 launches %d in training (expected %d), %d in the validation of %d; held-out error "
              "%r (bound %.2f); last step loss %.6f" % (tag, route, launches[route], 2 * steps,
                                                         launches[route + "Validate"], len(images) - split,
                                                         errors[route], DATA_LENET_ERROR, losses[route][-1]))

        if launches[route] != 2 * steps or len(losses[route]) != steps or not errors[route] <= DATA_LENET_ERROR:
            fail("[%s] LeNet %s: K1 launches %d (expected %d), %d steps, held-out error %r" %
                 (tag, route, launches[route], 2 * steps, len(losses[route]), errors[route]))

    same = losses["direct"] == losses["serial"]
    print("[%s] LeNet: the direct and Serial routes' %d step losses bit-equal: %s" % (tag, steps, same))
    if not same or errors["direct"] != errors["serial"]:
        fail("[%s] LeNet's routes differ: losses equal %s, errors %r and %r" % (tag, same, errors["direct"],
                                                                                errors["serial"]))

    return {"lenet": launches["direct"], "lenetSerial": launches["serial"],
            "lenetValidate": launches["directValidate"]}


def _dataNiN(torch, tag, card, images, labels):
    """The CIFAR-10 NIN on ``cnncifar10nin``'s recipe over DATA_NIN_IMAGES
    standardized images in chunks, shifted on a threaded Serial and inline:
    each route timed over all the chunks, then the card's idle share in one
    steady-state chunk under the profiler (the Serial's chunk trained while
    its threads shift the next; the inline chunk shifted, then trained)."""
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.rng import globalRng
    from puzzlelib_tpu_torch.testlib import cnncifar10nin
    from puzzlelib_tpu_torch.tools.dataslice import ShiftAugment
    from puzzlelib_tpu_torch.transformers import Serial
    from puzzlelib_tpu_torch.transformers.provider import _mergeShards, _shardChunk

    images = cnncifar10nin.standardize(images)[:DATA_NIN_IMAGES]
    labels = labels[:DATA_NIN_IMAGES]
    chunks = DATA_NIN_IMAGES // DATA_NIN_CHUNK

    def threaded():
        with Serial(images, labels, numofthreads=DATA_THREADS) as serial:
            serial.addTransformer(ShiftAugment(DATA_THREADS))
            yield from _dataChunks(serial, chunks, DATA_NIN_CHUNK)

    def inline():
        shift = ShiftAugment(DATA_THREADS)
        for k in range(chunks):
            rows = slice(k * DATA_NIN_CHUNK, (k + 1) * DATA_NIN_CHUNK)
            shards = _shardChunk((images[rows], labels[rows]), DATA_THREADS)
            yield _mergeShards([shift(shard, idx) for idx, shard in enumerate(shards)])

    def fresh(losses=None):
        _, _, trainer, _ = cnncifar10nin.buildTraining()
        if losses is not None:
            trainer.onBatchFinish = lambda h: losses.append(h.cost.getError())

        globalRng.seed(Cnn.DROPOUT_SEED)
        np.random.seed(DATA_SEEDS["shuffle"])
        return trainer

    def timed(trainer, feed):
        synchronize()
        start = time.perf_counter()
        for chunk, chunkLabels in feed:
            trainer.trainFromHost(chunk, chunkLabels, macroBatchSize=cnncifar10nin.MACRO_BATCH)
        synchronize()
        return time.perf_counter() - start

    warm = fresh()
    rows = warm.batchsize + DATA_NIN_CHUNK % warm.batchsize
    warm.trainFromHost(images[:rows], labels[:rows], macroBatchSize=cnncifar10nin.MACRO_BATCH)

    routes = {"threads": threaded, "inline": inline}
    losses, secs, counts, idle = {}, {}, {}, {}
    for route, feed in routes.items():
        losses[route] = []
        _resetCounters()
        secs[route] = timed(fresh(losses[route]), feed())
        counts[route] = _readCounters()

    profileStart = time.perf_counter()
    for route, feed in routes.items():
        trainer, stream = fresh(), feed()
        trainer.trainFromHost(*next(stream), macroBatchSize=cnncifar10nin.MACRO_BATCH)
        idle[route] = _profiledLaunches("%s] [nin %s" % (tag, route),
                                        lambda: timed(trainer, itertools.islice(stream, 1)))[1]
        stream.close()
    print("[time] [%s] [nin] the two routes' runs %.1f s, their profiled chunks %.1f s" %
          (tag, sum(secs.values()), time.perf_counter() - profileStart))

    for route, what in (("threads", "shifted on %d threads of a Serial while the card trains" % DATA_THREADS),
                        ("inline", "shifted inline on the main thread before each trainFromHost")):
        _dataRate(tag, "CIFAR-10 NIN f32, MomentumSGD(%g, %g) with WeightDecay(%g), %d parsed images in chunks of %d "
                  "%s, %d steps; idle share of the card in one chunk under the profiler %.1f %%" %
                  (cnncifar10nin.LEARN_RATE, cnncifar10nin.MOM_RATE, cnncifar10nin.WEIGHT_DECAY, len(images),
                   DATA_NIN_CHUNK, what, len(losses[route]), 100 * idle[route]), len(images), secs[route], card,
                  unit="images")

    finite = all(np.isfinite(losses[route]).all() for route in losses)
    handLaunches = {route: sum(counts[route].values()) for route in counts}
    print("[%s] NIN: step losses finite %s (first %.6f, last %.6f); the two routes' losses bit-equal %s; hand-kernel "
          "launches %s (its 192-channel convs go to cuDNN)" % (tag, finite, losses["threads"][0],
                                                               losses["threads"][-1],
                                                               losses["threads"] == losses["inline"], handLaunches))
    if not finite or any(handLaunches.values()):
        fail("[%s] NIN: finite losses %s, hand-kernel launches %s" % (tag, finite, handLaunches))


def _dataLSTM(torch, tag, card, data, labels):
    """The IMDB LSTM of ``rnnimdbtrain`` on ``_imdb``'s recipe over the
    first DATA_LSTM_ROWS parsed rows; returns K1's launches."""
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.ops.hopper import matmul
    from puzzlelib_tpu_torch.testlib import _imdb, rnnimdbtrain

    np.random.seed(0)
    trainer, _ = _imdb.buildTraining(rnnimdbtrain.buildNet())
    losses = []
    trainer.onBatchFinish = lambda h: losses.append(h.cost.getError())

    np.random.seed(DATA_SEEDS["shuffle"])
    _resetCounters()
    synchronize()
    start = time.perf_counter()
    trainer.trainFromHost(data[:DATA_LSTM_ROWS], labels[:DATA_LSTM_ROWS], macroBatchSize=_imdb.TRAIN_SPLIT)
    synchronize()
    secs = time.perf_counter() - start
    launches, steps = matmul.launches, DATA_LSTM_ROWS // trainer.batchsize

    _dataRate(tag, "IMDB LSTM f32, Adam(%g) and BCE, %d parsed rows in %d steps of %d" %
              (_imdb.ALPHA, DATA_LSTM_ROWS, len(losses), trainer.batchsize), DATA_LSTM_ROWS, secs, card)
    print("[%s] LSTM: K1 launches %d at the head (expected %d); step losses %s" %
          (tag, launches, steps, " ".join("%.6f" % loss for loss in losses)))
    if launches != steps or len(losses) != steps or not np.isfinite(losses).all():
        fail("[%s] LSTM: K1 launches %d (expected %d), losses %s" % (tag, launches, steps, losses))

    return launches


def phaseData(torch, card):
    """[data]: the datasets' raw files written from a seed at their
    published sizes in a temporary directory, parsed by the port's loaders
    and fed to LeNet, the CIFAR-10 NIN and the IMDB LSTM on the card (see
    the module's docstring, item 41).  Returns K1's launches and the parsed
    MNIST and IMDB arrays, which [testlib] trains on."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.testlib import rnnimdbtrain
    from puzzlelib_tpu_torch.tools import dataslice as Data

    Config.device = "cuda"
    Config.globalEvalMode = False
    Config.gemmAlgo = Config.convAlgo = "hopper"
    tag = "data"

    parts, start = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as path:
        raw = {"mnist": Data.writeMnist(path, seed=DATA_SEEDS["files"]),
               "cifar": Data.writeCifar(path, seed=DATA_SEEDS["files"]),
               "imdbWords": Data.writeImdb(path, seed=DATA_SEEDS["files"])}
        parts["files"] = time.perf_counter() - start
        print("[%s] raw files written in %.2f s: %s" % (tag, parts["files"], ", ".join(
            "%s %d bytes" % (name, os.path.getsize(os.path.join(path, name))) for name in sorted(os.listdir(path)))))

        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            again = pool.submit(Data.parseImdb, path, DATA_SEEDS["imdb"], rnnimdbtrain.NUMWORDS, rnnimdbtrain.MAXLEN)
            mnist, cifar, imdb = _dataParse(tag, card, path, raw)
            parts["parse"] = time.perf_counter() - start - sum(parts.values())

            launches = _dataLeNet(torch, tag, card, *mnist)
            parts["lenet"] = time.perf_counter() - start - sum(parts.values())
            _dataNiN(torch, tag, card, *cifar)
            parts["nin"] = time.perf_counter() - start - sum(parts.values())
            launches["lstm"] = _dataLSTM(torch, tag, card, *imdb)
            parts["lstm"] = time.perf_counter() - start - sum(parts.values())

            _dataParsedAgain(tag, card, imdb, again)

    print("[time] [%s] by part: %s" % (tag, ", ".join("%s %.1f s" % item for item in parts.items())))
    return launches, mnist, imdb


# [testlib]: the counterparts' stated runs where the script's full run does
# not fit the phase (the NIN's 300 epochs, the autoencoder's 40 epochs of
# 70000 images), and optimizenet's calls a timing
TESTLIB_NIN_EPOCHS = 20
TESTLIB_ENCODER_EPOCHS = 2
TESTLIB_OPTIMIZE_LOOP = 3
TESTLIB_IMAGE = (1, 3, 480, 640)
TESTLIB_BOUND = 1e-5
TESTLIB_PROFILE_PAD = 64


def _testlibCounts(tag, what, counts, want):
    """Print ``what``'s launches by kernel; fail unless each kernel named in
    ``want`` (name -> predicate on its count, with the rule's text) holds
    and every other kernel launched no time."""
    byKernel = {"K1": counts["matmul"], "K2": counts["winograd"] - counts["winogradDataGrad"],
                "K2-bwd": counts["winogradDataGrad"], "K3": counts["winogradFG"], "K4": counts["flash"],
                "K5a": counts["flashDq"], "K5b": counts["flashDkv"]}
    print("[%s] %s: launches %s (K1 on wgmma %d, K4 on wgmma %d)" % (tag, what, byKernel, counts["matmulWgmma"],
                                                                     counts["flashWgmma"]))
    for kernel, count in byKernel.items():
        rule, text = want.get(kernel, (lambda n: n == 0, "none"))
        if not rule(count):
            fail("[%s] %s: %s launched %d times, expected %s" % (tag, what, kernel, count, text))

    return byKernel


def _testlibRun(tag, what, run, want, profileRun=None):
    """``run()`` with the counters reset just before and read just after,
    timed on the host clock between two synchronizes; then the card's idle
    share of ``profileRun`` (``run`` itself by default) under the profiler,
    its launches held to the device events.  Returns (run's result, its
    launches by kernel, its seconds).

    Late in the script the profiler has lost ~25 device events of a
    session, every time (an autoencoder epoch showed 33 of its 34 K1
    launches, 842 events against 868 in a fresh process): the profiled
    window opens and closes with TESTLIB_PROFILE_PAD one-element adds,
    timed with the run, so that events lost at its edges are no hand
    kernel's."""
    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.backend.device import synchronize

    _resetCounters()
    synchronize()
    start = time.perf_counter()
    result = run()
    synchronize()
    secs = time.perf_counter() - start
    counts = _testlibCounts(tag, what, _readCounters(), want)

    pad = gpuarray.zeros((1, ))

    def timed():
        synchronize()
        begin = time.perf_counter()
        for _ in range(TESTLIB_PROFILE_PAD):
            pad.add_(1.0)
        (profileRun or run)()
        for _ in range(TESTLIB_PROFILE_PAD):
            pad.add_(1.0)
        synchronize()
        return time.perf_counter() - begin

    idle = _profiledLaunches(tag, timed)[1]
    print("[%s] %s: %.3f s wall; idle share of the card %.1f %% under the profiler (%s)" %
          (tag, what, secs, 100 * idle, "the same run" if profileRun is None else "a shorter run of it"))
    return result, counts, secs


def phaseTestlib(torch, card, mnist, imdb):
    """[testlib]: the last nine ``testlib`` counterparts on the card, each
    through its own entry point (see the module's docstring, item 43).
    Returns the launches by script and kernel."""
    import contextlib
    import io

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.testlib import (ctctrain, digitslenet, digitsnin, digitsreal, encodertrain,
                                             gradientcheck, normfilters, optimizenet, transformertrain)
    from puzzlelib_tpu_torch.tools import dataslice as Data

    tag = "testlib"
    Config.device = "cuda"
    Config.globalEvalMode = False
    Config.gemmAlgo = Config.convAlgo = "hopper"
    K1 = {"K1": (lambda n: n > 0, "some")}
    seen = {}

    try:
        import sklearn  # noqa: F401
        sk = "imports here"
    except ImportError:
        sk = "does not import here"
    images, target = Data.digits()
    print("[%s] the digits scripts train on tools/dataslice.digits: seeded arrays of the UCI digits' shape and "
          "range (%d x 8 x 8 in [%d, %d], 10 class templates with each pixel moved by -1, 0 or +1); scikit-learn "
          "%s, and the loaders (loadDigits, loadDigits32) are held to the root scripts' by the CPU twins" %
          (tag, len(images), images.min(), images.max(), sk))

    # gradientcheck: 33 central differences, cuDNN's convs, no hand kernel
    out = io.StringIO()

    def check():
        np.random.seed(0)
        with contextlib.redirect_stdout(out):
            return gradientcheck.main()

    errors, _, _ = _testlibRun(tag, "gradientcheck.main()", check, {})
    print("[%s] gradientcheck: %d relative errors, median %.3e, max %.3e (gate: median below 1e-2)" %
          (tag, len(errors), np.median(errors), np.max(errors)))
    if len(errors) != 33 or not np.median(errors) < 1e-2:
        fail("[%s] gradientcheck: %d errors, median %r" % (tag, len(errors), np.median(errors)))

    # digitslenet: the script's 15 epochs through FusedTrainer, K1 in the two Linears
    splits = digitslenet.prepareDigits(images, target)
    accuracy, seen["digitslenet"], _ = _testlibRun(
        tag, "digitslenet.train(15 epochs)", lambda: digitslenet.train(*splits), K1,
        lambda: digitslenet.train(*splits, epochs=1))
    print("[%s] digitslenet: held-out accuracy %.4f (gate %.2f)" % (tag, accuracy, digitslenet.ACCURACY_GATE))
    if not accuracy >= digitslenet.ACCURACY_GATE:
        fail("[%s] digitslenet: accuracy %r" % (tag, accuracy))

    # digitsreal: the tied autoencoder (K1 twice a step: the encoder's forward product and the decoder's
    # untransposed data-gradient product) and the LSTM, the scripts' 40 epochs each
    realImages, realLabels = digitsreal.prepareDigits(images, target)
    steps = 40 * (len(realImages) // 100)
    err, seen["autoencoder"], _ = _testlibRun(
        tag, "digitsreal.trainAutoencoder(40 epochs, %d steps)" % steps,
        lambda: digitsreal.trainAutoencoder(realImages), {"K1": (lambda n: n == 2 * steps, "%d" % (2 * steps))},
        lambda: digitsreal.trainAutoencoder(realImages, epochs=1))
    print("[%s] digitsreal autoencoder: MSE %.5f (gate below %g)" % (tag, err, digitsreal.MSE_GATE))
    if not err < digitsreal.MSE_GATE:
        fail("[%s] autoencoder: MSE %r" % (tag, err))

    accuracy, seen["lstm"], _ = _testlibRun(
        tag, "digitsreal.trainLstm(40 epochs)", lambda: digitsreal.trainLstm(realImages, realLabels), K1,
        lambda: digitsreal.trainLstm(realImages, realLabels, epochs=1))
    print("[%s] digitsreal lstm: held-out accuracy %.4f (gate %.2f)" % (tag, accuracy, digitsreal.ACCURACY_GATE))
    if not accuracy >= digitsreal.ACCURACY_GATE:
        fail("[%s] lstm: accuracy %r" % (tag, accuracy))

    # digitsnin: a stated number of epochs (the script's 300 take ~1 min); its 192-channel convs go to cuDNN
    ninData, ninLabels = digitsnin.prepareDigits32(images, target)
    (trainErrors, valErrors), seen["digitsnin"], _ = _testlibRun(
        tag, "digitsnin.train(%d epochs, stepsPerDispatch=11)" % TESTLIB_NIN_EPOCHS,
        lambda: digitsnin.train(ninData.copy(), ninLabels, epochs=TESTLIB_NIN_EPOCHS), {},
        lambda: digitsnin.train(ninData.copy(), ninLabels, epochs=1))
    print("[%s] digitsnin: train error %.5f -> %.5f over %d of the script's 300 epochs, held-out error %.5f "
          "(the gate, accuracy 0.95, is for the full run)" % (tag, trainErrors[0], trainErrors[-1],
                                                             TESTLIB_NIN_EPOCHS, valErrors[-1]))
    if not (np.isfinite(trainErrors).all() and trainErrors[-1] < trainErrors[0]):
        fail("[%s] digitsnin: train errors %s" % (tag, trainErrors))

    # encodertrain: [data]'s 70000 parsed MNIST images as rows, a stated number of epochs (no filter dump)
    rows = mnist[0].reshape(len(mnist[0]), -1)
    steps = TESTLIB_ENCODER_EPOCHS * (len(rows) // encodertrain.BATCH)
    with tempfile.TemporaryDirectory() as path:
        errors, seen["encodertrain"], _ = _testlibRun(
            tag, "encodertrain.train(%d epochs of %d images, %d steps)" % (TESTLIB_ENCODER_EPOCHS, len(rows), steps),
            lambda: encodertrain.train(rows, epochs=TESTLIB_ENCODER_EPOCHS, datapath=path),
            {"K1": (lambda n: n == 2 * steps, "%d" % (2 * steps))}, lambda: encodertrain.train(rows[:10000], epochs=1,
                                                                                    datapath=path))
    print("[%s] encodertrain: error %s (the script dumps its filters every %d epochs, with PIL)" %
          (tag, " -> ".join("%.6f" % e for e in errors), encodertrain.DUMP_EVERY))
    if not (np.isfinite(errors).all() and errors[-1] < errors[0]):
        fail("[%s] encodertrain: errors %s" % (tag, errors))

    # normfilters: SubtractMean and LCN on a seeded 3 x 480 x 640 image, held to the CPU run
    img = np.random.RandomState(5).rand(*TESTLIB_IMAGE).astype(np.float32) * 2 - 1
    maps, _, _ = _testlibRun(tag, "normfilters.normalize(%s f32)" % (TESTLIB_IMAGE, ),
                             lambda: normfilters.normalize(img), {})
    Config.device = "cpu"
    ref = normfilters.normalize(img)
    Config.device = "cuda"
    errs = [relErr(torch, got.cpu(), want) for got, want in zip(maps, ref)]
    print("[%s] normfilters: SubtractMean and LCN on the card against the CPU: max |diff| / max |ref| %s "
          "(bound %.0e)" % (tag, " ".join("%.2e" % e for e in errs), TESTLIB_BOUND))
    if not all(e <= TESTLIB_BOUND for e in errs):
        fail("[%s] normfilters: %s" % (tag, errs))

    # ctctrain: the script's 200 steps and its gate (main asserts it); cuDNN's 1-d convs and the host CTC loops
    (first, last, ctcSecs), seen["ctctrain"], secs = _testlibRun(
        tag, "ctctrain.main(200)", lambda: ctctrain.main(200), {}, lambda: _ctcSteps(ctctrain, 10))
    print("[%s] ctctrain: NLL %.4f -> %.4f (%.1f %%, gate below %.0f %%), 200 steps in %.3f s on %s" %
          (tag, first, last, 100 * last / first, 100 * ctctrain.GATE, secs, card))
    total, inCtc = _ctcSteps(ctctrain, 20)
    print("[%s] ctctrain: 20 more steps in %.3f s, %.3f s of it in the CTC cost calls (%.1f %%: the host loops of "
          "ops/ctc.py and their small ops, each call fenced by a synchronize)" % (tag, total, inCtc,
                                                                                  100 * inCtc / total))

    # transformertrain: one epoch of [data]'s IMDB rows on each attention route
    data, labels = imdb
    routes = {"xla": ({**K1}, None, "f32, the script's route"),
              "flash": ({**K1, **{k: (lambda n: n > 0, "some") for k in ("K4", "K5a", "K5b")}}, torch.bfloat16,
                        "bf16: the flash kernels take bf16 and f16")}
    for algo, (want, dtype, note) in routes.items():
        np.random.seed(DATA_SEEDS["shuffle"])
        (trainErrors, accuracies), seen["transformertrain-" + algo], secs = _testlibRun(
            tag, "transformertrain.train(1 epoch, attnAlgo=%r, %s)" % (algo, note),
            lambda: transformertrain.train(data, labels, epochs=1, attnAlgo=algo, dtype=dtype), want,
            lambda: transformertrain.train(data[:2560], labels[:2560], epochs=1, attnAlgo=algo, dtype=dtype,
                                           split=2048))
        print("[%s] transformertrain %s: train error %.6f, accuracy %.4f, %.0f rows/s trained and validated on %s" %
              (tag, algo, trainErrors[0], accuracies[0], len(data) / secs, card))
        if not (np.isfinite(trainErrors).all() and 0.0 <= accuracies[0] <= 1.0):
            fail("[%s] transformertrain %s: %s %s" % (tag, algo, trainErrors, accuracies))

    # optimizenet: VGG-16 at batch 16 in bf16, the eager and the fused trainer
    calls = 2 * (TESTLIB_OPTIMIZE_LOOP + 1)
    (eager, fusedSecs), counts, _ = _testlibRun(
        tag, "optimizenet.main(16, looplength=%d, bf16)" % TESTLIB_OPTIMIZE_LOOP,
        lambda: optimizenet.main(16, TESTLIB_OPTIMIZE_LOOP, torch.bfloat16),
        {k: (lambda n: n >= 10 * calls and n % 10 == 0, "10 a step") for k in ("K2", "K2-bwd", "K3")} |
        {"K1": (lambda n: n >= 3 * calls and n % 3 == 0, "3 a step")})
    seen["optimizenet"] = counts
    stepsRun = counts["K2"] // 10
    if not counts["K2"] == counts["K2-bwd"] == counts["K3"] == 10 * stepsRun or counts["K1"] != 3 * stepsRun:
        fail("[%s] optimizenet: launches %s for %d steps" % (tag, counts, stepsRun))
    print("[%s] optimizenet: %d steps counted (%d calls and the fused step's warm-up), K2 / K2-bwd / K3 10 a step "
          "and K1 3 a step; VGG-16 bf16 at batch 16: eager %.6f s a step, fused %.6f s a step on %s" %
          (tag, stepsRun, calls, eager, fusedSecs, card))

    return seen


def _ctcSteps(ctctrain, steps):
    """``steps`` of ``ctctrain``'s loop, without its gate: (their seconds,
    the seconds in the CTC cost calls), each call fenced by a synchronize."""
    from puzzlelib_tpu_torch.backend.device import synchronize

    net, optimizer, cost, rng, embed = ctctrain.buildTraining()
    datalen = np.full((ctctrain.BATCH, ), ctctrain.LABLEN * ctctrain.STRETCH // 2, dtype=np.int32)
    inCost = [0.0]

    def timedCost(pred, target):
        synchronize()
        begin = time.perf_counter()
        result = cost(pred, target)
        synchronize()
        inCost[0] += time.perf_counter() - begin
        return result

    synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        data, labels, lengths = ctctrain.makeBatch(rng, embed)
        ctctrain.step(net, optimizer, timedCost, data, datalen, labels, lengths)
    synchronize()
    return time.perf_counter() - start, inCost[0]


CKPT_STEPS = 8


def _ckptRebuild(net):
    """``net`` rebuilt from its blueprint after a JSON round trip, as a
    file's blueprint would rebuild it (every init scheme "none")."""
    from puzzlelib_tpu_torch.blueprint import BlueprintFactory

    return BlueprintFactory().build(json.loads(json.dumps(net.getBlueprint(), sort_keys=True)))


def _ckptSameBits(torch, tag, what, got, want):
    """Fail unless the variables of ``got`` hold those of ``want`` bit for
    bit, on the card."""
    wantVars = {name: var.data for var, names in want.getVarTable().items() for name in names}
    gotVars = {name: var.data for var, names in got.getVarTable().items() for name in names}
    if sorted(gotVars) != sorted(wantVars):
        fail("[%s] %s: variable names %s, expected %s" % (tag, what, sorted(gotVars), sorted(wantVars)))

    for name, value in wantVars.items():
        tensor = gotVars[name]
        if tensor.device.type != "cuda" or tensor.dtype != value.dtype or \
                not torch.equal(tensor.view(torch.int16), value.view(torch.int16)):
            fail("[%s] %s: variable %s is not the saved one bit for bit on the card (%s, %s)" %
                 (tag, what, name, tensor.device, tensor.dtype))


def _ckptVgg(torch, tag, card, net, images):
    """The served VGG-16 bf16 saved into a ``MemoryStore``, rebuilt from its
    blueprint, ``calcMode(bf16)``, loaded, and served: outputs bit-equal to
    the original net's, 12 K1 (all on wgmma) and 40 K2 launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator

    Config.gemmAlgo = Config.convAlgo = "hopper"
    want = Calculator(net, batchsize=BATCH).calcFromHost(images)

    secs = {}
    synchronize()
    start = time.perf_counter()
    store = MemoryStore()
    net.save(store)
    secs["save"] = time.perf_counter() - start

    start = time.perf_counter()
    rebuilt = _ckptRebuild(net)
    synchronize()
    secs["rebuild"] = time.perf_counter() - start

    start = time.perf_counter()
    rebuilt.calcMode(torch.bfloat16)
    rebuilt.load(store)
    synchronize()
    secs["load"] = time.perf_counter() - start
    megabytes = store.nbytes() / 1e6

    _ckptSameBits(torch, tag, "VGG-16 rebuilt and loaded", rebuilt, net)
    rebuilt.evalMode()

    _resetCounters()
    got = Calculator(rebuilt, batchsize=BATCH).calcFromHost(images)
    counts = _readCounters()
    launches = {"matmul": counts["matmul"], "matmulWgmma": counts["matmulWgmma"], "winograd": counts["winograd"]}

    print("[%s] VGG-16 bf16 (%d variables, %.1f MB in the store): save %.4f s, blueprint rebuild %.4f s, calcMode "
          "and load %.4f s (%.1f MB/s host to card) on %s" %
          (tag, len(rebuilt.getVarTable()), megabytes, secs["save"], secs["rebuild"], secs["load"],
           megabytes / secs["load"], card))
    print("[%s] the rebuilt net served %d images in %d requests of %d: launches %s; output bit-equal to the served "
          "net's: %s" % (tag, len(images), REQUESTS, BATCH, launches, np.array_equal(got, want)))

    if launches != {"matmul": 3 * REQUESTS, "matmulWgmma": 3 * REQUESTS, "winograd": 10 * REQUESTS}:
        fail("[%s] expected 40 Winograd and 12 GEMM launches, all 12 on wgmma, got %s" % (tag, launches))
    if got.shape != want.shape or not np.array_equal(got, want):
        fail("[%s] the rebuilt and loaded VGG-16 does not serve the saved net's output bit for bit" % tag)

    return launches, secs, megabytes


def _ckptLeNet(torch, fusedRoute):
    """LeNet f32 from ``np.random.seed(1234)`` with ``MomentumSGD(0.1,
    0.9)`` in global state, on the eager or the fused trainer."""
    from puzzlelib_tpu_torch.models.nets import loadLeNet

    np.random.seed(1234)
    net = loadLeNet(None, initscheme=None)
    return net, _ckptTrainer(net, fusedRoute)


def _ckptTrainer(net, fusedRoute):
    """(optimizer, trainer) of ``net``: ``MomentumSGD(0.1, 0.9)`` in global
    state, ``CrossEntropy``, the eager or the fused trainer at batch 128."""
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.fused import FusedTrainer
    from puzzlelib_tpu_torch.handlers import Trainer
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    optimizer = MomentumSGD(0.1, 0.9)
    optimizer.setupOn(net, useGlobalState=True)
    trainerCls = FusedTrainer if fusedRoute else Trainer
    return optimizer, trainerCls(net, CrossEntropy(maxlabels=10), optimizer, batchsize=Cnn.BATCH)


def _ckptSteps(trainer, images, labels):
    """``CKPT_STEPS`` steps of ``Cnn.BATCH`` in order: the step losses."""
    losses = []
    trainer.onBatchFinish = lambda h: losses.append(h.cost.getError())
    trainer.trainFromHost(images, labels, macroBatchSize=len(images), random=False)
    return losses


def _ckptResume(torch, tag, fusedRoute, images, labels):
    """8 steps, save net and optimizer, 8 more (the reference run); a fresh
    LeNet from the blueprint with a fresh optimizer in global state loads
    both and takes the same 8 steps: losses and variables bit-equal to the
    reference run's.  On the fused route the fresh trainer records its CUDA
    graph before the load (one step on zeroed weights): the load must keep
    every address, so no new recording is made.  Returns K1's launches in
    the resumed steps."""
    first, rest = images[:len(images) // 2], images[len(images) // 2:]
    firstLabels, restLabels = labels[:len(labels) // 2], labels[len(labels) // 2:]
    route = "fused" if fusedRoute else "eager"

    net, (optimizer, trainer) = _ckptLeNet(torch, fusedRoute)
    _ckptSteps(trainer, first, firstLabels)
    netStore, optStore = MemoryStore(), MemoryStore()
    net.save(netStore)
    optimizer.save(optStore)
    reference = _ckptSteps(trainer, rest, restLabels)

    fresh = _ckptRebuild(net)
    freshOpt, freshTrainer = _ckptTrainer(fresh, fusedRoute)
    captures = None
    if fusedRoute:
        for pack in freshOpt.shParams.values():
            pack.ary.zero_()
        _ckptSteps(freshTrainer, first[:Cnn.BATCH], firstLabels[:Cnn.BATCH])
        captures = freshTrainer.step.captures

    addresses = [tensor.data_ptr() for tensor in [var.data for var in fresh.getVarTable()] +
                 [t for state in freshOpt.states.values() for t in state.values()]]
    fresh.load(netStore)
    freshOpt.load(optStore)
    moved = addresses != [tensor.data_ptr() for tensor in [var.data for var in fresh.getVarTable()] +
                          [t for state in freshOpt.states.values() for t in state.values()]]

    _resetCounters()
    resumed = _ckptSteps(freshTrainer, rest, restLabels)
    launches = _readCounters()["matmul"]

    print("[%s] LeNet f32 %s, MomentumSGD(0.1, 0.9) in global state: %d steps of %d, save, %d more; resumed from "
          "the blueprint: losses %s (reference %s); step t %d; K1 launches in the resumed steps %d; variable and "
          "state addresses kept across the load: %s%s" %
          (tag, route, CKPT_STEPS, Cnn.BATCH, CKPT_STEPS, " ".join("%.6f" % x for x in resumed),
           " ".join("%.6f" % x for x in reference), freshOpt.t, launches, not moved,
           "" if captures is None else "; recordings %d before the load, %d after" %
           (captures, freshTrainer.step.captures)))

    if moved:
        fail("[%s] %s: the load moved a variable or an optimizer state" % (tag, route))
    if resumed != reference:
        fail("[%s] %s: the resumed losses are not the reference run's bit for bit" % (tag, route))
    if captures is not None and freshTrainer.step.captures != captures:
        fail("[%s] fused: the load made the trainer record anew (%d -> %d recordings)" %
             (tag, captures, freshTrainer.step.captures))
    if launches != 2 * CKPT_STEPS:
        fail("[%s] %s: expected %d K1 launches in the resumed steps, got %d" % (tag, route, 2 * CKPT_STEPS, launches))
    _ckptSameBits(torch, tag, "LeNet %s resumed" % route, fresh, net)

    return launches


def phaseCheckpoint(torch, card, net, images):
    """[ckpt]: save and load on the card, through a ``MemoryStore`` (see the
    module's docstring, item 42).  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config

    tag = "ckpt"
    Config.device = "cuda"
    start = time.perf_counter()

    launches, secs, megabytes = _ckptVgg(torch, tag, card, net, images)

    Config.globalEvalMode = False   # training needs gradient buffers
    Config.gemmAlgo = Config.convAlgo = "hopper"
    lenetImages, lenetLabels = Cnn.data("lenet", 2 * CKPT_STEPS * Cnn.BATCH, seed=7)
    launches["lenet"] = _ckptResume(torch, tag, False, lenetImages, lenetLabels)
    launches["lenetFused"] = _ckptResume(torch, tag, True, lenetImages, lenetLabels)

    print("[time] [%s] %.1f s (save %.4f s, rebuild %.4f s, load %.4f s of %.1f MB)" %
          (tag, time.perf_counter() - start, secs["save"], secs["rebuild"], secs["load"], megabytes))
    return launches


# [convert]: ResNet-50's batch norms write their running stats times this
# scale factor, as Caffe's BatchNorm layer keeps them (a power of two, so
# the importer's division is exact); enginespeed's arguments on the card
CONVERT_SCALE_FACTOR = 4.0
CONVERT_ENGINESPEED = ["--net", "nin", "--batch", "128", "--dtypes", "bfloat16,int8", "--many", "8", "--iters", "10"]

# the ONNX nodes of VGG-16 by type: 13 convs, 15 relus, 5 max pools, the
# flatten, fc6-fc8 as a MatMul and an Add each, the softmax; 32 initializers
VGG_ONNX_NODES = {"Conv": 13, "Relu": 15, "MaxPool": 5, "Flatten": 1, "MatMul": 3, "Add": 3, "Softmax": 1}
VGG_ONNX_INITIALIZERS = 32


def _convertTimed(secs, what, fn):
    """``fn()``, its seconds to the card's end kept in ``secs[what]``."""
    from puzzlelib_tpu_torch.backend.device import synchronize

    synchronize()
    start = time.perf_counter()
    result = fn()
    synchronize()
    secs[what] = time.perf_counter() - start
    return result


def _convertServed(tag, what, net, images, want, expect):
    """Serve ``images`` on the imported ``net``, the counters reset just
    before and read just after; fail unless the output is ``want`` bit for
    bit and the launches are ``expect``."""
    from puzzlelib_tpu_torch.handlers import Calculator

    net.evalMode()
    _resetCounters()
    got = Calculator(net, batchsize=BATCH).calcFromHost(images)
    counts = _readCounters()
    launches = {key: counts[key] for key in expect}

    same = got.shape == want.shape and np.array_equal(got, want)
    print("[%s] %s served %d images in %d requests of %d: launches %s; output bit-equal to the source net's: %s" %
          (tag, what, len(images), REQUESTS, BATCH, launches, same))

    if launches != expect:
        fail("[%s] %s: expected the launches %s, got %s" % (tag, what, expect, launches))
    if not same or not np.isfinite(got).all():
        fail("[%s] %s does not serve the source net's output bit for bit" % (tag, what))

    return launches


def _convertImport(torch, tag, card, what, path, write, parse, fill, build):
    """Write a model file (``write(path)``), parse it (``parse(path)``),
    import it into a ``MemoryStore`` (``fill(parsed, store)``), build the
    net from the store (``build(store)``) and cast it to bf16, each step
    timed; the file is deleted.  Returns (net, seconds by step, MB)."""
    secs = {}
    _convertTimed(secs, "write", lambda: write(path))
    parsed = _convertTimed(secs, "parse", lambda: parse(path))
    store = MemoryStore()
    _convertTimed(secs, "import", lambda: fill(parsed, store))

    def load():
        net = build(store)
        net.calcMode(torch.bfloat16)
        return net

    net = _convertTimed(secs, "load", load)
    megabytes = os.path.getsize(path) / 1e6
    os.remove(path)

    print("[%s] %s, %.1f MB: %s on %s" % (tag, what, megabytes, ", ".join(
        "%s %.3f s (%.1f MB/s)" % (step, t, megabytes / t) for step, t in secs.items()), card))
    return net, secs, megabytes


def _writeBytes(data):
    def write(path):
        with open(path, "wb") as f:
            f.write(data())

    return write


def _mxnetParsed(paramsPath):
    """(keys, tensors, symbols) of a ``.params`` file and its
    ``-symbol.json``, read as ``converter.mxnet.convert`` reads them."""
    from puzzlelib_tpu_torch.converter import mxnet

    with open(paramsPath, "rb") as f:
        mxnet.readHeader(f)
        tensors = mxnet.readData(f)
        keys = mxnet.readKeys(f)

    return keys, tensors, mxnet.convertmodel.loadSymbols(paramsPath.replace(".params", "-symbol.json"))


def _convertOnnx(tag, card, workdir, net, inshape, wantNodes, wantInits):
    """Export ``net`` from the card with ``ONNXExporter``, parse the file
    back: fail unless its nodes by type and its initializer count are
    ``wantNodes`` / ``wantInits`` and every initializer holds the bytes of
    ``gpuarray.get`` of its variable or attribute.  Returns (seconds, MB)."""
    from puzzlelib_tpu_torch.converter.onnx import ONNXExporter, onnxmodel
    from puzzlelib_tpu_torch.tools import convertslice as Files

    secs = {}
    _convertTimed(secs, "export", lambda: ONNXExporter().export(net, inshape, workdir))
    path = os.path.join(workdir, "%s.onnx" % net.name)

    def parse():
        with open(path, "rb") as f:
            return onnxmodel.parseModel(f.read())

    graph = _convertTimed(secs, "parse", parse)["graph"]
    megabytes = os.path.getsize(path) / 1e6
    os.remove(path)

    nodes = {}
    for node in graph["nodes"]:
        nodes[node["op_type"]] = nodes.get(node["op_type"], 0) + 1

    values = Files.onnxInitializers(net)
    inits = graph["initializer"]
    same = len(inits) == len(values) and all(
        init["vals"].tobytes() == value.astype("<f4").tobytes() for init, value in zip(inits, values))

    print("[%s] ONNX %s: %d nodes %s, %d initializers, each the card's weights byte for byte: %s; %.1f MB, export "
          "%.3f s (%.1f MB/s), parse %.3f s on %s" % (tag, net.name, len(graph["nodes"]), nodes, len(inits), same,
                                                      megabytes, secs["export"], megabytes / secs["export"],
                                                      secs["parse"], card))

    if nodes != wantNodes or len(inits) != wantInits:
        fail("[%s] ONNX %s: nodes %s and %d initializers, expected %s and %d" %
             (tag, net.name, nodes, len(inits), wantNodes, wantInits))
    if not same:
        fail("[%s] ONNX %s: an initializer differs from the card's weights" % (tag, net.name))

    return secs, megabytes


def _convertResNet(torch, tag, card, workdir, images):
    """ResNet-50 bf16 from ``resnetslice.build`` (He, seed 0) with seeded
    running stats, written as a new-format caffemodel (He et al.'s layout),
    imported, loaded by ``loadResNet``, served: bit-equal, 52 K2 and 4 K1.
    Returns (the source net, launches, seconds, MB)."""
    from puzzlelib_tpu_torch import convert
    from puzzlelib_tpu_torch.converter.caffe import js2hdf, loadNetParameter
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.models.nets import loadResNet
    from puzzlelib_tpu_torch.tools import convertslice as Files

    source = Res.build()
    source.calcMode(torch.bfloat16)
    rng = np.random.RandomState(3)
    convert.attrsFromNumpy(source, {
        name: (rng.randn(*attr.shape) * 0.1 if name.endswith(".mean") else rng.rand(*attr.shape) + 0.5)
        .astype(np.float32) for name, attr in source.getAttrTable().items()})
    source.evalMode()
    want = Calculator(source, batchsize=BATCH).calcFromHost(images)

    convs = len(Res.winogradConvs(source, (BATCH, ) + Res.SHAPE))
    imported, secs, megabytes = _convertImport(
        torch, tag, card, "Caffe ResNet-50-model.caffemodel (new format, BatchNorm scale factor %.1f)" %
        CONVERT_SCALE_FACTOR, os.path.join(workdir, "ResNet-50-model.caffemodel"),
        _writeBytes(lambda: Files.caffeFromNet(source, CONVERT_SCALE_FACTOR)), loadNetParameter, js2hdf,
        lambda store: loadResNet(store, "50"))
    launches = _convertServed(tag, "the Caffe ResNet-50", imported, images, want,
                              {"matmul": REQUESTS, "matmulWgmma": REQUESTS, "winograd": convs * REQUESTS})
    return source, launches, secs, megabytes


def phaseConvert(torch, card, net, images):
    """[convert]: the converters on the card, right after [ckpt], on the
    served VGG-16 bf16 (``net``) and its 4 requests (``images``): VGG-16
    through a V1 caffemodel and an MXNet ``.params`` file, ResNet-50 through
    a new-format caffemodel, each imported into a ``MemoryStore``, loaded
    through the zoo loader and served bit-equal to the source net with the
    slice's launches; both nets exported to ONNX from the card and parsed
    back; ``enginespeed`` on the NiN.  The files go to a work directory
    under ``build/`` and are deleted after use.  Returns the launches."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.benchmarks import enginespeed
    from puzzlelib_tpu_torch.converter.caffe import js2hdf, loadNetParameter
    from puzzlelib_tpu_torch.converter.mxnet import buildHdf
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.ops.hopper import build
    from puzzlelib_tpu_torch.tools import convertslice as Files

    tag = "convert"
    Config.device = "cuda"
    Config.globalEvalMode = True   # serving nets: no gradient buffers
    Config.gemmAlgo = Config.convAlgo = "hopper"
    started = time.perf_counter()

    net.evalMode()
    want = Calculator(net, batchsize=BATCH).calcFromHost(images)
    vggLaunches = {"matmul": 3 * REQUESTS, "matmulWgmma": 3 * REQUESTS, "winograd": 10 * REQUESTS}
    launches, seconds = {}, {}

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as workdir:
        imported, seconds["caffe-v1"], _ = _convertImport(
            torch, tag, card, "Caffe V1 %s.caffemodel" % net.name, os.path.join(workdir, "%s.caffemodel" % net.name),
            _writeBytes(lambda: Files.caffeV1FromNet(net)), loadNetParameter, js2hdf,
            lambda store: loadVGG(store, "16"))
        launches["caffeV1"] = _convertServed(tag, "the Caffe V1 VGG-16", imported, images, want, vggLaunches)
        del imported

        def writeMxnet(path):
            Files.writeMxnet(net, path[:-len(".params")])

        imported, seconds["mxnet"], _ = _convertImport(
            torch, tag, card, "MXNet %s.params and -symbol.json" % net.name, os.path.join(workdir, "%s.params" %
                                                                                          net.name),
            writeMxnet, _mxnetParsed, lambda parsed, store: buildHdf(*parsed, store, net.name),
            lambda store: loadVGG(store, "16"))
        os.remove(os.path.join(workdir, "%s-symbol.json" % net.name))
        launches["mxnet"] = _convertServed(tag, "the MXNet VGG-16", imported, images, want, vggLaunches)
        del imported
        torch.cuda.empty_cache()

        resnet, launches["caffeResNet"], seconds["caffe-resnet"], _ = _convertResNet(torch, tag, card, workdir,
                                                                                      images)

        seconds["onnx-vgg"], _ = _convertOnnx(tag, card, workdir, net, (BATCH, 3, 224, 224), VGG_ONNX_NODES,
                                              VGG_ONNX_INITIALIZERS)
        counts, inits = Files.onnxCounts(resnet)
        seconds["onnx-resnet"], _ = _convertOnnx(tag, card, workdir, resnet, (BATCH, ) + Res.SHAPE, counts, inits)
        del resnet
        torch.cuda.empty_cache()

        if Files.onnxCounts(net) != (VGG_ONNX_NODES, VGG_ONNX_INITIALIZERS):
            fail("[%s] onnxCounts of VGG-16 gives %s, not the table's" % (tag, Files.onnxCounts(net)))

        _resetCounters()
        start = time.perf_counter()
        rates = enginespeed.main(CONVERT_ENGINESPEED + ["--workdir", workdir])
        seconds["enginespeed"] = time.perf_counter() - start
        launches["enginespeed"] = _readCounters()

    Config.globalEvalMode = False
    torch.cuda.empty_cache()

    if sorted(rates) != ["bfloat16", "int8"] or not all(t > 0 for pair in rates.values() for t in pair):
        fail("[%s] enginespeed gave no two rates for each of bf16 and int8: %s" % (tag, rates))
    batch = int(CONVERT_ENGINESPEED[CONVERT_ENGINESPEED.index("--batch") + 1])
    print("[%s] enginespeed %s: %s; launches in the run (both builds, calibration and timings) %s" %
          (tag, " ".join(CONVERT_ENGINESPEED), ", ".join(
              "%s eager %.1f / many %.1f images/s" % (dtype, batch / eager, batch / many)
              for dtype, (eager, many) in rates.items()), {k: v for k, v in launches["enginespeed"].items() if v}))
    print("[time] [%s] %.1f s (%s)" % (tag, time.perf_counter() - started, ", ".join(
        "%s %.1f s" % (what, sum(t.values()) if isinstance(t, dict) else t) for what, t in seconds.items())))
    return launches


# [grid]: testlib/multigpumnist.py's recipe on two nodes sharing card 0 over
# gloo, against the single process; a one-rank NCCL mesh step against the
# step over no mesh
GRID_NODES = 2
GRID_TRAIN, GRID_VALIDATE = 12800, 2000
GRID_MESH_STEPS = 20
GRID_TIMEOUT = 300
GRID_WEIGHT_BOUND = 1e-5
GRID_LOSS_BOUND = 1e-4
GRID_LOSS_STEPS = 10


def _gridRel(got, want):
    """Largest |got - want| over max(1, max |want|), over the arrays of two
    {name: array} tables with the same names."""
    return max(float(np.abs(got[name] - value).max()) / max(1.0, float(np.abs(value).max()))
               for name, value in want.items())


def phaseGrid(torch, card, mnist):
    """[grid] (see the module's docstring, item 46).  Returns K1's launches:
    each node's over its 100 training steps, and the mesh step's over its
    20."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.grid import runGrid
    from puzzlelib_tpu_torch.testlib import multigpumnist
    from puzzlelib_tpu_torch.tools import gridslice

    Config.device = "cuda"
    Config.gemmAlgo = Config.convAlgo = "hopper"
    tag = "grid"
    images, labels = mnist[0][:GRID_TRAIN + GRID_VALIDATE], mnist[1][:GRID_TRAIN + GRID_VALIDATE]
    batch = multigpumnist.GLOBAL_BATCH
    steps = GRID_TRAIN // batch

    synchronize()
    final, oracle = gridslice.oracle(images, labels, GRID_NODES, GRID_TRAIN)
    oracleRate = (steps - 1) * batch / (oracle.stamps[-1] - oracle.stamps[0])

    # (b)'s node starts beside (a)'s, sets its mesh up and waits for (a) to
    # end before it trains: the spawns overlap, the card's work does not
    with tempfile.TemporaryDirectory() as outdir, tempfile.TemporaryDirectory() as meshDir, \
            ThreadPoolExecutor(1) as pool:
        gate = os.path.join(meshDir, "go")
        spawned = time.time()
        meshJob = pool.submit(runGrid, gridslice.meshNode, 1, images, labels, GRID_MESH_STEPS, meshDir, gate=gate,
                              timeout=GRID_TIMEOUT)

        try:
            runGrid(gridslice.mnistNode, GRID_NODES, images, labels, GRID_TRAIN, GRID_VALIDATE, outdir, spawned,
                    devices=[0] * GRID_NODES, timeout=GRID_TIMEOUT)
        finally:
            open(gate, "w").close()

        gridSecs = time.time() - spawned
        nodes = gridslice.load(outdir, "mnist", GRID_NODES)
        meshJob.result()
        meshSecs = time.time() - spawned - gridSecs
        mesh = gridslice.load(meshDir, "mesh", 1)[0]

    finals = [{key[len("final/"):]: value for key, value in node.items() if key.startswith("final/")}
              for node in nodes]
    firsts = [{key[len("first/"):]: value for key, value in node.items() if key.startswith("first/")}
              for node in nodes]
    sameWeights = all(np.array_equal(node[name], finals[0][name]) for node in finals[1:] for name in finals[0])
    sameErrors = all(np.array_equal(node["history"], nodes[0]["history"]) for node in nodes[1:])

    gridLosses = np.mean([node["losses"] for node in nodes], axis=0)
    lossGaps = np.abs(gridLosses - np.asarray(oracle.losses)) / np.abs(np.asarray(oracle.losses))
    firstRel = _gridRel(firsts[0], oracle.first)
    finalRel = _gridRel(finals[0], final)

    perStep = oracle.launches[-1] // steps
    launches = [int(node["launches"][-1]) for node in nodes]
    steady = max(node["stamps"][-1] - node["stamps"][0] for node in nodes)
    trainErr, valErr = nodes[0]["history"][-1]

    print("[%s] multigpumnist.train on %d nodes sharing card 0 over gloo (two processes time-slicing one card, not "
          "a scaling figure): %d images in %d steps of %d a node (global batch %d), %d validated; grid %.1f s from "
          "spawn to the last node's end on %s" % (tag, GRID_NODES, GRID_TRAIN, steps, batch // GRID_NODES, batch,
                                                 GRID_VALIDATE, gridSecs, card))
    print("[%s] steps 2-%d: grid %.1f images/s (the slower node's wall time from step 1's end to step %d's), the "
          "single-process oracle %.1f images/s on the same card; spawn to a node's target %.2f s (slowest), "
          "first step %.2f s (slowest, the net's build and node 0's broadcast included)" %
          (tag, steps, (steps - 1) * batch / steady, steps, oracleRate, max(float(n["spawnSecs"]) for n in nodes),
           max(float(n["stamps"][0]) for n in nodes)))
    print("[%s] sumTensor of LeNet's %d f32 parameters (%.2f MB) over gloo between the two processes: %.3f ms a "
          "step (node 0), %.3f ms (node 1), mean of %d calls" %
          (tag, int(nodes[0]["params"]), int(nodes[0]["params"]) * 4 / 1e6, float(nodes[0]["allreduceMs"]),
           float(nodes[1]["allreduceMs"]), gridslice.ALLREDUCE_CALLS))
    print("[%s] nodes' final weights bit-equal: %s; meanValue gave both nodes the same errors: %s (global train "
          "error %r, validation error %r)" % (tag, sameWeights, sameErrors, float(trainErr), float(valErr)))
    worst = int(np.argmax(lossGaps))
    print("[%s] against the oracle: weights after step 1 %.3e, after step %d %.3e (bound %.0e of max(1, max |w|)); "
          "step losses' largest relative gap %.3e over the first %d steps (bound %.0e), %.3e over the %d (at step "
          "%d: grid %.9g, oracle %.9g; not a gate: the losses fall towards 0, where a relative gap measures the "
          "rounding of a vanishing number)" %
          (tag, firstRel, steps, finalRel, GRID_WEIGHT_BOUND, float(lossGaps[:GRID_LOSS_STEPS].max()),
           GRID_LOSS_STEPS, GRID_LOSS_BOUND, float(lossGaps.max()), steps, worst + 1, float(gridLosses[worst]),
           float(oracle.losses[worst])))
    print("[%s] K1 launches (gemmF32) over the %d training steps: nodes %s, the oracle %d a step" %
          (tag, steps, launches, perStep))

    if not (sameWeights and sameErrors and max(firstRel, finalRel) <= GRID_WEIGHT_BOUND and
            lossGaps[:GRID_LOSS_STEPS].max() <= GRID_LOSS_BOUND):
        fail("[%s] the grid disagrees: weights bit-equal %s, errors equal %s, step 1 %.3e, step %d %.3e, losses "
             "%.3e" % (tag, sameWeights, sameErrors, firstRel, steps, finalRel,
                       float(lossGaps[:GRID_LOSS_STEPS].max())))
    if perStep != 2 or launches != [perStep * steps] * GRID_NODES:
        fail("[%s] expected %d K1 launches in each node, got %s (the oracle %d a step)" %
             (tag, perStep * steps, launches, perStep))

    names = [key[len("single/"):] for key in mesh if key.startswith("single/") and "." in key]
    sameMesh = all(np.array_equal(mesh["mesh/" + name], mesh["single/" + name]) for name in names)
    ncclKernels = [str(name) for name in mesh["kernels"] if "nccl" in name.lower() or "onerank" in name.lower()]

    print("[%s] one-rank mesh (runGrid of one node on card 0, NCCL, its node spawned beside the two and let onto "
          "the card when they ended), LeNet f32 through FusedStep(mesh=...) and over no mesh, %d steps of %d each, "
          "%.1f s after the two ended (in the node: mesh set-up %.2f s, the first %d mesh steps %.2f s, the profiled "
          "step %.2f s, the first %d steps over no mesh %.2f s): weights bit-equal %s; graphs recorded %d and %d; "
          "K1 launches %d and %d; NCCL kernels in the profiled replay: %s" %
          (tag, GRID_MESH_STEPS, batch, meshSecs, float(mesh["secs/setup"]), GRID_MESH_STEPS - 1,
           float(mesh["secs/mesh"]), float(mesh["secs/profiled"]), GRID_MESH_STEPS - 1, float(mesh["secs/single"]),
           sameMesh, int(mesh["mesh/captures"]), int(mesh["single/captures"]), int(mesh["mesh/launches"]),
           int(mesh["single/launches"]), ncclKernels))

    if not (sameMesh and int(mesh["mesh/captures"]) == int(mesh["single/captures"]) == 1 and ncclKernels):
        fail("[%s] the mesh step: bit-equal %s, recordings %d and %d, NCCL kernels %s" %
             (tag, sameMesh, int(mesh["mesh/captures"]), int(mesh["single/captures"]), ncclKernels))
    if not int(mesh["mesh/launches"]) == int(mesh["single/launches"]) >= 2 * GRID_MESH_STEPS:
        fail("[%s] the mesh step's K1 launches %d, over no mesh %d" %
             (tag, int(mesh["mesh/launches"]), int(mesh["single/launches"])))

    return {"nodes": launches, "mesh": int(mesh["mesh/launches"])}


# [model-parallel]: testlib/pipelinemoe.py's trunk on four ranks sharing
# card 0 over gloo against the one-process microbatched oracle, expert and
# sequence parallelism on the same ranks, and LeNet's tensor-parallel and
# ZeRO fused steps on a one-rank NCCL mesh against the steps over no mesh
MP_RANKS = 4
MP_EPOCHS = 2
MP_FUSED_STEPS = 20
MP_TIMEOUT = 300
MP_WEIGHT_BOUND = 1e-5
MP_LOSS_BOUND = 1e-4
MP_LOSS_STEPS = 10
MP_EAGER_BOUND = 1e-5
MP_EXPERT_BOUND = 1e-5
MP_SEQ_BOUND = 1e-4


def phaseModelParallel(torch, card):
    """[model-parallel] (see the module's docstring, item 47).  Returns K1's
    launches (each rank's over its training, each rank's last validation
    forward's, each rank's expert-parallel forward's, and the tensor-parallel
    and ZeRO steps') and K1 against its plain version at the pipelined
    trunk's shapes."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.grid import runGrid
    from puzzlelib_tpu_torch.ops.hopper import matmul
    from puzzlelib_tpu_torch.testlib import pipelinemoe
    from puzzlelib_tpu_torch.tools import gridslice, moeslice, mpslice

    Config.device = "cuda"
    Config.gemmAlgo = Config.convAlgo = "hopper"
    tag = "model-parallel"
    data = moeslice.data()
    steps = MP_EPOCHS * len(data[0]) // pipelinemoe.BATCH
    fusedImages, fusedLabels = Cnn.data("lenet", MP_FUSED_STEPS * mpslice.FUSED_BATCH)

    # the five processes start together and import torch while the parent
    # runs the oracle; (a)'s ranks train once it has ended, (c)'s node once
    # (a) and (b) have
    with tempfile.TemporaryDirectory() as outdir, tempfile.TemporaryDirectory() as fusedDir, \
            ThreadPoolExecutor(2) as pool:
        pipeGate, fusedGate = os.path.join(outdir, "go"), os.path.join(fusedDir, "go")
        spawned = time.time()
        pipeJob = pool.submit(runGrid, mpslice.pipeNode, MP_RANKS, data, MP_EPOCHS, outdir, spawned, gate=pipeGate,
                              devices=[0] * MP_RANKS, timeout=MP_TIMEOUT)
        fusedJob = pool.submit(runGrid, mpslice.fusedNode, 1, fusedImages, fusedLabels, MP_FUSED_STEPS, fusedDir,
                               gate=fusedGate, timeout=MP_TIMEOUT)

        try:
            synchronize()
            oracle, final = mpslice.oracle(data, MP_EPOCHS)
            oracleSecs = time.time() - spawned
        finally:
            open(pipeGate, "w").close()

        try:
            pipeJob.result()
        finally:
            open(fusedGate, "w").close()

        pipeSecs = time.time() - spawned
        fusedJob.result()
        fusedSecs = time.time() - spawned - pipeSecs
        nodes = gridslice.load(outdir, "pipe", MP_RANKS)
        fused = gridslice.load(fusedDir, "fused", 1)[0]

    finals = [{key[len("final/"):]: value for key, value in node.items() if key.startswith("final/")}
              for node in nodes]
    first = {key[len("first/"):]: value for key, value in nodes[0].items() if key.startswith("first/")}
    sameWeights = all(np.array_equal(node[name], finals[0][name]) for node in finals[1:] for name in finals[0])
    firstRel, finalRel = _gridRel(first, oracle.first), _gridRel(finals[0], final)
    lossGaps = np.abs(nodes[0]["losses"] - np.asarray(oracle.losses)) / np.abs(np.asarray(oracle.losses))
    eagerGap = max(float(node["eagerGap"]) for node in nodes)

    perStep, perForward = mpslice.stepLaunches(), mpslice.forwardLaunches()
    wantLaunches = perStep * steps + perForward * MP_EPOCHS
    launches = [int(node["trainLaunches"]) for node in nodes]
    validationLaunches = [int(node["validationLaunches"]) for node in nodes]
    stepCounts = sorted({int(n) for node in nodes
                         for n in np.diff(node["launches"])[np.arange(steps - 1) % (steps // MP_EPOCHS) !=
                                                             steps // MP_EPOCHS - 1]})
    steady = max(node["stamps"][-1] - node["stamps"][0] for node in nodes)
    oracleSteady = oracle.stamps[-1] - oracle.stamps[0]

    print("[%s] testlib/pipelinemoe.py's trunk (%d parameters, f32) on %d ranks of a 'stage' axis sharing card 0 "
          "over gloo (four processes time-slicing one card, not a scaling figure): %d steps of %d rows in %d "
          "microbatches (%d epochs of %d rows), then distributedForward of %d validation rows; %.1f s from spawn to "
          "the ranks' end on %s" % (tag, sum(value.size for value in finals[0].values()), MP_RANKS, steps,
                                    pipelinemoe.BATCH, pipelinemoe.MICROBATCHES, MP_EPOCHS, len(data[0]),
                                    len(data[2]), pipeSecs, card))
    print("[%s] steps 2-%d: ranks %.1f rows/s (the slowest rank's wall time from step 1's end to step %d's, the "
          "first epoch's validation forward included), the one-process oracle %.1f rows/s on the same card (no "
          "validation); spawn to a rank's target %.2f s (slowest, the oracle's %.2f s overlapping it); a stage "
          "handoff of a (%d, %d) f32 microbatch %.3f ms (rank %d, through the host)" %
          (tag, steps, (steps - 1) * pipelinemoe.BATCH / steady, steps,
           (steps - 1) * pipelinemoe.BATCH / oracleSteady, max(float(n["spawnSecs"]) for n in nodes), oracleSecs,
           pipelinemoe.BATCH // pipelinemoe.MICROBATCHES, pipelinemoe.DIM, float(nodes[-1]["handoffMs"]),
           MP_RANKS - 1))
    print("[%s] ranks' final weights bit-equal: %s; against the oracle: weights after step 1 %.3e, after step %d "
          "%.3e (bound %.0e of max(1, max |w|)); losses' largest relative gap %.3e over the first %d steps (bound "
          "%.0e), %.3e over the %d; distributedForward against the eager pipe on each %d-row microbatch %.3e "
          "(bound %.0e); validation accuracy %.4f" %
          (tag, sameWeights, firstRel, steps, finalRel, MP_WEIGHT_BOUND, float(lossGaps[:MP_LOSS_STEPS].max()),
           MP_LOSS_STEPS, MP_LOSS_BOUND, float(lossGaps.max()), steps, len(data[2]) // pipelinemoe.MICROBATCHES,
           eagerGap, MP_EAGER_BOUND, float(nodes[0]["history"][-1][1])))
    print("[%s] K1 launches (gemmF32) on each rank: %s over the training, %d expected (%d a step: %d products a "
          "stage forward x (%d microbatches + %d recomputed), x %d steps; + %d a validation forward x %d); a step's "
          "own counts %s; the last validation forward's %s" %
          (tag, launches, wantLaunches, perStep, mpslice.STAGE_PRODUCTS, pipelinemoe.MICROBATCHES,
           pipelinemoe.MICROBATCHES - 1, steps, perForward, MP_EPOCHS, stepCounts, validationLaunches))

    if not (sameWeights and max(firstRel, finalRel) <= MP_WEIGHT_BOUND and
            lossGaps[:MP_LOSS_STEPS].max() <= MP_LOSS_BOUND and eagerGap <= MP_EAGER_BOUND):
        fail("[%s] the pipeline disagrees: weights bit-equal %s, step 1 %.3e, step %d %.3e, losses %.3e, eager %.3e" %
             (tag, sameWeights, firstRel, steps, finalRel, float(lossGaps[:MP_LOSS_STEPS].max()), eagerGap))
    if launches != [wantLaunches] * MP_RANKS or stepCounts != [perStep] or \
            validationLaunches != [perForward] * MP_RANKS:
        fail("[%s] expected %d K1 launches on each rank (%d a step, %d a validation forward), got %s (steps %s, "
             "validation %s)" % (tag, wantLaunches, perStep, perForward, launches, stepCounts, validationLaunches))

    expertGaps = [float(np.abs(node["expert/out"] - node["expert/eager"]).max()) /
                  max(1.0, float(np.abs(node["expert/eager"]).max())) for node in nodes]
    sameAux = all(np.array_equal(node["expert/aux"], node["expert/eagerAux"]) for node in nodes)
    expertLaunches = [int(node["expert/launches"]) for node in nodes]
    seqGaps = [float(node["seq/gap"]) for node in nodes]
    print("[%s] SwitchMoE(%d, capacityFactor=2.0).distributedForward of %d rows over an 'expert' axis of %d, one "
          "expert a rank: against the eager layer %.3e (bound %.0e), auxLoss equal %s, K1 launches %s (one expert "
          "each), %.2f ms (rank 0, eager layer not timed)" %
          (tag, pipelinemoe.DIM, len(data[2]), MP_RANKS, max(expertGaps), MP_EXPERT_BOUND, sameAux, expertLaunches,
           float(nodes[0]["expert/ms"])))
    print("[%s] seqParallelMLP x (%d, %d), w1 (%d, %d), w2 (%d, %d) f32 over a 'model' axis of %d against the dense "
          "F.gelu(x @ w1, approximate='tanh') @ w2 on the card (Config.matmulPrecision %r, TF32 %s): largest gap "
          "over max |dense| %.3e (bound %.0e); %.2f ms sharded (three gloo collectives), %.2f ms dense "
          "(rank 0)" % (tag, mpslice.SEQ_TOKENS, mpslice.SEQ_WIDTH, mpslice.SEQ_WIDTH, mpslice.SEQ_HIDDEN,
                        mpslice.SEQ_HIDDEN, mpslice.SEQ_WIDTH, MP_RANKS, Config.matmulPrecision,
                        "on" if torch.backends.cuda.matmul.allow_tf32 else "off", max(seqGaps), MP_SEQ_BOUND,
                        float(nodes[0]["seq/ms"]), float(nodes[0]["seq/denseMs"])))
    if not (max(expertGaps) <= MP_EXPERT_BOUND and sameAux and expertLaunches == [1] * MP_RANKS and
            max(seqGaps) <= MP_SEQ_BOUND):
        fail("[%s] expert or sequence parallelism disagrees: expert %.3e, aux equal %s, launches %s, seq %.3e" %
             (tag, max(expertGaps), sameAux, expertLaunches, max(seqGaps)))

    fusedLaunches = {}
    for kind, what in (("tp", "tensorParallelSpecs with MomentumSGD"), ("zero", "zeroOptimizerSpecs with Adam")):
        names = [key[len(kind + "/single/"):] for key in fused if key.startswith(kind + "/single/") and "." in key]
        same = all(np.array_equal(fused["%s/mesh/%s" % (kind, name)], fused["%s/single/%s" % (kind, name)])
                   for name in names)
        captures = (int(fused[kind + "/mesh/captures"]), int(fused[kind + "/single/captures"]))
        counts = (int(fused[kind + "/mesh/launches"]), int(fused[kind + "/single/launches"]))
        fusedLaunches[kind] = counts[0]

        print("[%s] LeNet f32 through FusedStep(stateShardings=%s) over a one-rank NCCL (data 1, model 1) mesh "
              "(runGrid of one node on card 0, spawned beside the four ranks and let onto the card when they "
              "ended) and over no mesh, %d steps of %d each (in the node: %.2f s and %.2f s): weights bit-equal %s; "
              "graphs recorded %d and %d; K1 launches %d and %d; the profiled replay's kernels: %s" %
              (tag, what, MP_FUSED_STEPS, mpslice.FUSED_BATCH, float(fused["secs/%s/mesh" % kind]),
               float(fused["secs/%s/single" % kind]), same, captures[0], captures[1], counts[0], counts[1],
               [str(name) for name in fused[kind + "/kernels"]]))
        if not (names and same and captures == (1, 1) and counts[0] == counts[1] >= 2 * MP_FUSED_STEPS):
            fail("[%s] the %s step: bit-equal %s, recordings %s, K1 launches %s" % (tag, kind, same, captures, counts))

    print("[%s] the fused node %.1f s after the ranks ended (its mesh set-up %.2f s)" %
          (tag, fusedSecs, float(fused["secs/setup"])))

    # K1 at the shapes the ranks gave it, held against its plain version
    # here, once every node has left the card: a stage's trunk product on
    # a microbatch and its experts' at the microbatch's capacity
    rows = pipelinemoe.BATCH // pipelinemoe.MICROBATCHES
    capacity = max(1, int(np.ceil(rows * moeslice.CAPACITY_FACTOR / moeslice.EXPERTS)))
    gen = torch.Generator(device="cuda").manual_seed(33)
    gemm = {"max_abs_err": 0.0, "ms": 0.0, "wmma_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    binding = set()
    for label, m, count in (("mp-trunk", rows, 1), ("mp-expert", capacity, moeslice.EXPERTS)):
        _addCase(gemm, binding, _gemmCase(torch, matmul, gen, label, "f32", m, pipelinemoe.DIM, pipelinemoe.DIM),
                 count)

    return {"nodes": launches, "validation": validationLaunches, "expert": expertLaunches, "tp": fusedLaunches["tp"],
            "zero": fusedLaunches["zero"], "gemm": gemm}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test needs an NVIDIA GPU")

    started = time.perf_counter()

    from puzzlelib_tpu_torch.backend.device import ensureInit
    from puzzlelib_tpu_torch.ops.hopper import build, flash, matmul, phasesplit, probe, streamcopy, tapdot, winograd

    ensureInit()

    card = phaseDevice(torch)
    pool = ThreadPoolExecutor(max_workers=1)
    driverJob = phaseBuild(build, pool)
    installProbe, install = phaseCheckinstall(torch, matmul, probe)
    gemm, gemmTransformer = phaseGemm(torch, matmul)
    gemmInt8 = phaseGemmInt8(torch, matmul)
    wino, dataGrad, filterGrad = phaseWinograd(torch, winograd)
    attention = phaseFlash(torch, flash, build)
    serving, servedNet, servedImages = phaseSlice(torch, card)
    checkpoint = phaseCheckpoint(torch, card, servedNet, servedImages)
    phaseConvert(torch, card, servedNet, servedImages)
    del servedNet, servedImages
    torch.cuda.empty_cache()
    training = phaseTrain(torch, card)
    torch.cuda.empty_cache()
    transformer = phaseTransformer(torch, card)
    attentionDq, attentionDkv = phaseFlashBackward(torch, flash)
    torch.cuda.empty_cache()
    transformerTrain = phaseTransformerTrain(torch, card)
    torch.cuda.empty_cache()
    lenet, gemmLeNet = phaseLeNet(torch, card)
    ninCifar = phaseNiNCifar(torch, card)
    torch.cuda.empty_cache()
    ninServing, ninTraining, ninKernels = phaseNiN(torch, card)
    torch.cuda.empty_cache()
    fusedTrain = phaseFusedTransformerTrain(torch, card)
    torch.cuda.empty_cache()
    fusedServe = phaseFusedTransformerServe(torch, card)
    torch.cuda.empty_cache()
    fusedCnn = phaseFusedCnn(torch, card)
    torch.cuda.empty_cache()
    resnet, resnetKernels = phaseResNet50(torch, card)
    torch.cuda.empty_cache()
    phaseStart = time.perf_counter()
    unet, unetKernels = phaseUNet(torch, card)
    torch.cuda.empty_cache()
    print("[time] [unet] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    inception, inceptionKernels = phaseInception(torch, card)
    torch.cuda.empty_cache()
    print("[time] [inception] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    sequence, sequenceKernels = phaseImdbRnn(torch, card)
    torch.cuda.empty_cache()
    print("[time] [imdb-rnn] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    phaseW2L(torch, card)
    torch.cuda.empty_cache()
    print("[time] [w2l] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    zoo, zooKernels = phaseZooVision(torch, card)
    torch.cuda.empty_cache()
    print("[time] [zoo-vision] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    senti, sentiKernel = phaseSentiNet(torch, card)
    torch.cuda.empty_cache()
    print("[time] [sentinet] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    phaseCosts(torch)
    torch.cuda.empty_cache()
    print("[time] [costs] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    segnet, segnetKernels = phaseSegNet(torch, card)
    torch.cuda.empty_cache()
    print("[time] [segnet] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    alexnet, alexnetGemm = phaseClassifier(torch, card, "alexnet", Alex, torch.float32, CNN_LOSS_BOUND)
    torch.cuda.empty_cache()
    print("[time] [alexnet] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    c3d, c3dGemm = phaseClassifier(torch, card, "c3d", C3D, torch.bfloat16, SLICE_BOUND)
    torch.cuda.empty_cache()
    print("[time] [c3d] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    moe, moeGemm = phaseMoE(torch, card)
    torch.cuda.empty_cache()
    print("[time] [moe] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    graphPass = phaseGraphPass(torch, card)
    print("[time] [graph-pass] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    phaseRBM(torch, card)
    torch.cuda.empty_cache()
    print("[time] [rbm] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    vggAverage = phaseVggAverage(torch, card)
    print("[time] [vgg-avg] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    phaseLayers(torch)
    torch.cuda.empty_cache()
    print("[time] [layers] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    phaseAuto(torch, card)
    print("[time] [auto] %.1f s" % (time.perf_counter() - phaseStart))

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as workdir:
        net, requests, engineInt8, servedInt8 = phaseEngineInt8(torch, card, workdir)
        engineBf16, servedBf16 = phaseEngineBf16(torch, card, workdir, net, requests)
        del net, requests
        torch.cuda.empty_cache()
        engineFlash, servedFlash = phaseEngineFlash(torch, card, workdir)
        torch.cuda.empty_cache()
        engineDriver = phaseEngineDriver(torch, card, driverJob, workdir,
                                         {"int8": servedInt8, "bf16": servedBf16, "flash": servedFlash})
    pool.shutdown()
    torch.cuda.empty_cache()

    roofline = phaseStreamCopy(torch, streamcopy)
    phaseSlabs = phasePhaseSplit(torch, phasesplit)
    tapdotConv = phaseTapdot(torch, tapdot, winograd, build)
    measured = phaseMeasurementPath(torch, card)
    phaseStart = time.perf_counter()
    data, mnist, imdb = phaseData(torch, card)
    torch.cuda.empty_cache()
    print("[time] [data] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    testlib = phaseTestlib(torch, card, mnist, imdb)
    torch.cuda.empty_cache()
    print("[time] [testlib] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    grid = phaseGrid(torch, card, mnist)
    del mnist, imdb
    torch.cuda.empty_cache()
    print("[time] [grid] %.1f s" % (time.perf_counter() - phaseStart))
    phaseStart = time.perf_counter()
    modelParallel = phaseModelParallel(torch, card)
    torch.cuda.empty_cache()
    print("[time] [model-parallel] %.1f s" % (time.perf_counter() - phaseStart))

    source = "puzzlelib_tpu_torch/csrc/%s.cu"
    kernels = [
        dict(name="K0 install probe", route="cuda", source=source % "probe",
             replaces="puzzlelib_tpu/checkinstall.py:37", launches=install["probe"], **installProbe),
        dict(name="K1 tiled GEMM", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=training["matmul"],
             launches_wgmma=training["matmulWgmma"], serving_launches=serving["matmul"],
             engine_launches=engineBf16["matmul"], driver_launches=engineDriver["matmul"],
             measurement_launches=measured["K1"],
             measurement_launches_wgmma=measured["K1-wgmma"],
             fused_launches=fusedServe["matmul"] + fusedTrain["matmul"] + fusedCnn["lenet"] + fusedCnn["lenetValidate"],
             fused_launches_wgmma=fusedServe["matmulWgmma"] + fusedTrain["matmulWgmma"],
             avg_pool_serving_launches=vggAverage["matmul"], checkpoint_serving_launches=checkpoint["matmul"],
             checkpoint_serving_launches_wgmma=checkpoint["matmulWgmma"],
             testlib_launches=sum(counts["K1"] for counts in testlib.values()),
             optimizenet_launches=testlib["optimizenet"]["K1"], **gemm),
        dict(name="K1-int8 tiled GEMM, int8 -> int32 (matmul.py:54-56)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=engineInt8["int8"],
             launches_wgmma=engineInt8["int8Wgmma"], driver_launches=engineDriver["matmul_nt"],
             measurement_launches=measured["K1-int8"],
             measurement_launches_wgmma=measured["K1-int8-wgmma"], **gemmInt8),
        dict(name="K1 tiled GEMM at the transformer's shapes", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=transformer["matmul"],
             launches_wgmma=transformer["matmulWgmma"], fused_launches=fusedServe["matmul"],
             fused_launches_wgmma=fusedServe["matmulWgmma"], fused_training_launches=fusedTrain["matmul"],
             fused_training_launches_wgmma=fusedTrain["matmulWgmma"],
             transformertrain_launches=testlib["transformertrain-flash"]["K1"],
             transformertrain_xla_launches=testlib["transformertrain-xla"]["K1"], **gemmTransformer),
        dict(name="K1 tiled GEMM at LeNet's shapes (f32)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=lenet["train"],
             validation_launches=lenet["validate"], bf16_launches=lenet["bf16"],
             bf16_launches_wgmma=lenet["bf16Wgmma"], fused_launches=fusedCnn["lenet"],
             fused_validation_launches=fusedCnn["lenetValidate"], data_launches=data["lenet"],
             data_serial_launches=data["lenetSerial"], data_validation_launches=data["lenetValidate"],
             checkpoint_launches=checkpoint["lenet"], checkpoint_fused_launches=checkpoint["lenetFused"],
             grid_node_launches=grid["nodes"], grid_mesh_launches=grid["mesh"],
             mp_tp_launches=modelParallel["tp"], mp_zero_launches=modelParallel["zero"], **gemmLeNet),
        dict(name="K2 Winograd F(2x2,3x3) forward", route="cuda", source=source % "winograd",
             replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=training["winograd"] - training["winogradDataGrad"], serving_launches=serving["winograd"],
             engine_launches=engineBf16["winograd"], driver_launches=engineDriver["winograd_conv2d"],
             measurement_launches=measured["K2"],
             fused_launches=fusedCnn["nin"]["winograd"] - fusedCnn["nin"]["winogradDataGrad"],
             avg_pool_serving_launches=vggAverage["winograd"], checkpoint_serving_launches=checkpoint["winograd"],
             optimizenet_launches=testlib["optimizenet"]["K2"], **wino),
        dict(name="K2 Winograd F(2x2,3x3) as bwd-data (dataGradNHWC, winograd.py:725)", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=training["winogradDataGrad"], measurement_launches=measured["K2-bwd"],
             fused_launches=fusedCnn["nin"]["winogradDataGrad"], optimizenet_launches=testlib["optimizenet"]["K2-bwd"],
             **dataGrad),
        dict(name="K3 Winograd F(2x2,3x3) bwd-filter", route="cuda", source=source % "winograd_fg",
             replaces="puzzlelib_tpu/ops/pallas/winograd.py:457", launches=training["winogradFG"],
             measurement_launches=measured["K3"], fused_launches=fusedCnn["nin"]["winogradFG"],
             optimizenet_launches=testlib["optimizenet"]["K3"], **filterGrad),
        dict(name="K2 Winograd F(2x2,3x3) forward at the ImageNet NiN's conv3 and conv4-1024", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=ninTraining["winograd"] - ninTraining["winogradDataGrad"],
             serving_launches=ninServing["winograd"],
             fused_launches=fusedCnn["nin"]["winograd"] - fusedCnn["nin"]["winogradDataGrad"], **ninKernels["K2"]),
        dict(name="K2 Winograd F(2x2,3x3) as bwd-data at the ImageNet NiN's conv3 and conv4-1024", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=ninTraining["winogradDataGrad"], fused_launches=fusedCnn["nin"]["winogradDataGrad"],
             **ninKernels["K2-bwd"]),
        dict(name="K3 Winograd F(2x2,3x3) bwd-filter at the ImageNet NiN's conv3 and conv4-1024", route="cuda",
             source=source % "winograd_fg", replaces="puzzlelib_tpu/ops/pallas/winograd.py:457",
             launches=ninTraining["winogradFG"], fused_launches=fusedCnn["nin"]["winogradFG"], **ninKernels["K3"]),
        dict(name="K1 tiled GEMM at ResNet-50's fc1000 (bf16)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=resnet["training"]["matmul"],
             launches_wgmma=resnet["training"]["matmulWgmma"], serving_launches=resnet["serving"]["matmul"],
             fused_launches=resnet["fused"]["matmul"], fused_serving_launches=resnet["fusedServing"]["matmul"],
             graph_launches=graphPass["training"]["matmul"], graph_serving_launches=graphPass["serving"]["matmul"],
             **resnetKernels["K1"]),
        dict(name="K2 Winograd F(2x2,3x3) forward at ResNet-50's conv3_x, conv4_x and conv5_x", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=resnet["training"]["winograd"] - resnet["training"]["winogradDataGrad"],
             serving_launches=resnet["serving"]["winograd"],
             fused_launches=resnet["fused"]["winograd"] - resnet["fused"]["winogradDataGrad"],
             fused_serving_launches=resnet["fusedServing"]["winograd"],
             graph_launches=graphPass["training"]["winograd"] - graphPass["training"]["winogradDataGrad"],
             graph_serving_launches=graphPass["serving"]["winograd"], **resnetKernels["K2"]),
        dict(name="K2 Winograd F(2x2,3x3) as bwd-data at ResNet-50's conv3_x, conv4_x and conv5_x", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=resnet["training"]["winogradDataGrad"], fused_launches=resnet["fused"]["winogradDataGrad"],
             graph_launches=graphPass["training"]["winogradDataGrad"], **resnetKernels["K2-bwd"]),
        dict(name="K3 Winograd F(2x2,3x3) bwd-filter at ResNet-50's conv3_x, conv4_x and conv5_x", route="cuda",
             source=source % "winograd_fg", replaces="puzzlelib_tpu/ops/pallas/winograd.py:457",
             launches=resnet["training"]["winogradFG"], fused_launches=resnet["fused"]["winogradFG"],
             graph_launches=graphPass["training"]["winogradFG"], **resnetKernels["K3"]),
        dict(name="K2 Winograd F(2x2,3x3) forward at U-Net's 15 Winograd convs", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=unet["training"]["winograd"] - unet["training"]["winogradDataGrad"],
             serving_launches=unet["serving"]["winograd"], validation_launches=unet["validation"]["winograd"],
             fused_launches=unet["fused"]["winograd"] - unet["fused"]["winogradDataGrad"],
             fused_serving_launches=unet["fusedServing"]["winograd"], **unetKernels["K2"]),
        dict(name="K2 Winograd F(2x2,3x3) as bwd-data at U-Net's 15 Winograd convs", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=unet["training"]["winogradDataGrad"], fused_launches=unet["fused"]["winogradDataGrad"],
             **unetKernels["K2-bwd"]),
        dict(name="K3 Winograd F(2x2,3x3) bwd-filter at U-Net's 15 Winograd convs", route="cuda",
             source=source % "winograd_fg", replaces="puzzlelib_tpu/ops/pallas/winograd.py:457",
             launches=unet["training"]["winogradFG"], fused_launches=unet["fused"]["winogradFG"],
             **unetKernels["K3"]),
        dict(name="K2 Winograd F(2x2,3x3) forward at Inception-BN's two Winograd convs", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=inception["bn", "hopper"]["winograd"], fused_launches=inception["bn", "fused"]["winograd"],
             **inceptionKernels["K2"]),
        dict(name="K1 tiled GEMM at Inception-BN's fc1 (bf16)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=inception["bn", "hopper"]["matmul"],
             launches_wgmma=inception["bn", "hopper"]["matmulWgmma"],
             fused_launches=inception["bn", "fused"]["matmul"], **inceptionKernels["K1", "bn"]),
        dict(name="K1 tiled GEMM at Inception-v3's fc1 (bf16)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=inception["v3", "hopper"]["matmul"],
             launches_wgmma=inception["v3", "hopper"]["matmulWgmma"],
             fused_launches=inception["v3", "fused"]["matmul"], **inceptionKernels["K1", "v3"]),
        dict(name="K1 tiled GEMM at the IMDB sentiment nets' heads (f32)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=sequence["hopper"],
             sequence_launches=sequence["hopper"], fused_sequence_launches=sequence["fused"],
             validation_launches=sequence["validate"], fused_validation_launches=sequence["fusedValidate"],
             data_launches=data["lstm"], **sequenceKernels),
        *[dict(name="K2 Winograd F(2x2,3x3) forward at %s's convs" % Zoo.NAMES[kind], route="cuda",
               source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
               launches=zoo[kind, "hopper"]["winograd"], fused_launches=zoo[kind, "fused"]["winograd"],
               **zooKernels["K2", kind]) for kind in Zoo.NETS],
        dict(name="K1 tiled GEMM at MiniYolo's fc25-fc27 (bf16)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=zoo["miniyolo", "hopper"]["matmul"],
             launches_wgmma=zoo["miniyolo", "hopper"]["matmulWgmma"],
             fused_launches=zoo["miniyolo", "fused"]["matmul"], **zooKernels["K1"]),
        dict(name="K1 tiled GEMM at SentiNet's head (f32)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=senti["preset", "hopper"],
             optimizer_launches=senti["optimizers"]["hopper"], fused_optimizer_launches=senti["optimizers"]["fused"],
             **sentiKernel),
        dict(name="K2 Winograd F(2x2,3x3) forward at SegNet's 20 Winograd convs", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=segnet["training"]["winograd"] - segnet["training"]["winogradDataGrad"],
             serving_launches=segnet["serving"]["winograd"],
             fused_launches=segnet["fused"]["winograd"] - segnet["fused"]["winogradDataGrad"],
             fused_serving_launches=segnet["fusedServing"]["winograd"], **segnetKernels["K2"]),
        dict(name="K2 Winograd F(2x2,3x3) as bwd-data at SegNet's 20 Winograd convs", route="cuda",
             source=source % "winograd", replaces="puzzlelib_tpu/ops/pallas/winograd.py:79",
             launches=segnet["training"]["winogradDataGrad"], fused_launches=segnet["fused"]["winogradDataGrad"],
             **segnetKernels["K2-bwd"]),
        dict(name="K3 Winograd F(2x2,3x3) bwd-filter at SegNet's 20 Winograd convs", route="cuda",
             source=source % "winograd_fg", replaces="puzzlelib_tpu/ops/pallas/winograd.py:457",
             launches=segnet["training"]["winogradFG"], fused_launches=segnet["fused"]["winogradFG"],
             **segnetKernels["K3"]),
        *[dict(name="K1 tiled GEMM at %s's fc6-fc8 (%s)" % (net, dtName), route="cuda", source=source % "matmul",
               replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=seen["training"]["matmul"],
               launches_wgmma=seen["training"]["matmulWgmma"], serving_launches=seen["serving", "hopper"]["matmul"],
               fused_launches=seen["fused"]["matmul"], fused_serving_launches=seen["serving", "fused"]["matmul"],
               **gemms) for net, dtName, seen, gemms in (("AlexNet", "f32", alexnet, alexnetGemm),
                                                         ("C3D", "bf16", c3d, c3dGemm))],
        dict(name="K1 tiled GEMM at the MoE trunk's products (f32)", route="cuda", source=source % "matmul",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=moe["training"]["matmul"],
             launches_wgmma=moe["training"]["matmulWgmma"], serving_launches=moe["serving", "hopper"]["matmul"],
             fused_launches=moe["fused"]["matmul"], fused_serving_launches=moe["serving", "fused"]["matmul"],
             mp_node_launches=modelParallel["nodes"], mp_validation_launches=modelParallel["validation"],
             mp_expert_launches=modelParallel["expert"], mp_ms=modelParallel["gemm"]["ms"],
             mp_plain_ms=modelParallel["gemm"]["plain_ms"], mp_library_ms=modelParallel["gemm"]["library_ms"],
             mp_bound_ms=modelParallel["gemm"]["bound_ms"],
             **dict(moeGemm, max_abs_err=max(moeGemm["max_abs_err"], modelParallel["gemm"]["max_abs_err"]))),
        dict(name="K4 flash-attention forward", route="cuda", source=source % "flash",
             replaces="puzzlelib_tpu/ops/pallas/flash.py:25", launches=transformer["flash"],
             launches_wgmma=transformer["flashWgmma"], training_launches=transformerTrain["flash"],
             training_launches_wgmma=transformerTrain["flashWgmma"], engine_launches=engineFlash["flash"],
             driver_launches=engineDriver["flash"],
             engine_launches_wgmma=engineFlash["flashWgmma"], measurement_launches=measured["K4"],
             measurement_launches_wgmma=measured["K4-wgmma"], fused_launches=fusedServe["flash"],
             fused_launches_wgmma=fusedServe["flashWgmma"], fused_training_launches=fusedTrain["flash"],
             fused_training_launches_wgmma=fusedTrain["flashWgmma"],
             transformertrain_launches=testlib["transformertrain-flash"]["K4"], **attention),
        dict(name="K5a flash-attention dQ", route="cuda", source=source % "flash_bwd",
             replaces="puzzlelib_tpu/ops/pallas/flash.py:67", launches=transformerTrain["flashDq"],
             measurement_launches=measured["K5a"], fused_launches=fusedTrain["flashDq"],
             transformertrain_launches=testlib["transformertrain-flash"]["K5a"], **attentionDq),
        dict(name="K5b flash-attention dK/dV", route="cuda", source=source % "flash_bwd",
             replaces="puzzlelib_tpu/ops/pallas/flash.py:103", launches=transformerTrain["flashDkv"],
             measurement_launches=measured["K5b"], fused_launches=fusedTrain["flashDkv"],
             transformertrain_launches=testlib["transformertrain-flash"]["K5b"], **attentionDkv),
        dict(name="P1 tap-dot direct conv (probe)", route="cuda", source=source % "tapdot",
             replaces="tools/tapdot_probe.py:32", launches=measured["P1"], launches_wgmma=measured["P1-wgmma"],
             **tapdotConv),
        dict(name="P2 stride-2 phase-slab copy (probe)", route="cuda", source=source % "phasesplit",
             replaces="tools/strided_dma_probe.py:25", launches=measured["P2"], **phaseSlabs),
        dict(name="P3 streaming x + 1 (roofline probe)", route="cuda", source=source % "streamcopy",
             replaces="tools/roofline_probe.py:73", launches=measured["P3"], **roofline),
    ]
    print("[kernels] launches: K0 checkinstall's; K1-K3 the VGG training run's (4 steps of 32), serving_launches "
          "the VGG serving run's (4 requests of 32), engine_launches the VGG bf16 engine's (4 requests of 32); K1's "
          "launches_wgmma those of its launches on wgmma (K1-int8's too), wmma_ms the time of the WMMA kernel at "
          "the same shapes in the same call; "
          "K1-int8 the VGG int8 engine's (4 requests of 32); K1 at the transformer's shapes and K4 the transformer "
          "serving run's (4 requests of 64); ms, plain_ms, library_ms and bound_ms: the time one batch spends in "
          "the kernel, in its plain version, in the library call and at the card's bound (K0: one (8, 128) f32 "
          "block; K1: fc6+fc7+fc8 forward in bf16; K1-int8: the 16 int8 products of one request of 32 images "
          "(conv1_1's K padded to 32), the kernel through matmulNT on laid-out tables, plain in f64, library "
          "torch._int_mm; K1 at the transformer's shapes: the "
          "5 products of one request of 64 rows; K2 and K3: the 10 Winograd convs of a batch of 32, wrapper "
          "included, on NCHW operands (channels_last_ms and channels_last_library_ms on channels-last "
          "operands, as the training path hands them over); K4: one attention layer of the transformer slice, "
          "(64, 4, 80, 32), not causal, its launches_wgmma (and training_, engine_, measurement_launches_wgmma) "
          "those on the wgmma kernel, mma_ms the time of the first mma.sync kernel at the same shape in the same call; "
          "K5a and K5b: "
          "the backward of that layer, each kernel alone, plain_ms, library_ms and backward_ms the whole backward "
          "(dq, dk, dv) of backwardPlain, of scaled_dot_product_attention and of flash.backward, the delta pass "
          "included); K4's training_launches and K5's launches the "
          "transformer training run's (4 steps of 64), K4's engine_launches the flash engine's (4 requests of 8); "
          "P1-P3's launches and K1-K5's measurement_launches the measurement path's (the probe scripts and "
          "benchmarks); P1: the 5 convs of [P1-tapdot] together, the kernel on prepared operands, its "
          "launches_wgmma those on the wgmma kernel, mma_ms the first mma.sync kernel's time in the same call, "
          "library cuDNN on channels-last bf16; K0 and P3: medians of 5 alternating turns of 200 calls; P2: (1, "
          "64, 64, 256) at 4 rows a tile, library = plain, the permuted copy; P3: x + 1 on 64 Mi bf16 values, "
          "library torch.add; K1 at LeNet's shapes: its two f32 products at batch 128, launches those of [lenet]'s "
          "8 training steps of 128 (validation_launches its validation of 1024 images, bf16_launches and "
          "bf16_launches_wgmma its bf16 run's); K2, K2-bwd and K3 at the ImageNet NiN's conv3 and conv4-1024: the "
          "two convs at batch 128 on channels-last operands, library cuDNN on the same, medians of 5 alternating "
          "turns, launches [nin]'s 4 training steps of 128 (K2's serving_launches its 4 requests of 128); "
          "fused_launches (and fused_launches_wgmma) those of the fused paths, each kernel replayed from a CUDA "
          "graph: on the first K1, K2, K2-bwd and K3 entries all the fused phases' launches of the kernel together, "
          "K1 at the transformer's shapes and K4 [fused-transformer-serve]'s 4 requests of 64 "
          "(fused_training_launches [fused-transformer-train]'s 4 steps of 64 at 4 steps a dispatch, as K5a's and "
          "K5b's fused_launches), K1 at LeNet's shapes [fused-cnn]'s 8 steps of 128 (fused_validation_launches its "
          "validation of 1024), K2, K2-bwd and K3 at the NiN's convs [fused-cnn]'s 4 steps of 128; "
          "K1 at ResNet-50's fc1000: (32, 2048) x (2048, 1000) bf16, launches [resnet50]'s 12 training steps of 32 "
          "(serving_launches its 4 requests of 32, fused_ the FusedTrainer's and FusedCalculator's); K2, K2-bwd and "
          "K3 at ResNet-50's conv3_x, conv4_x and conv5_x: one conv of each of the three shapes at batch 32 on "
          "channels-last operands, library cuDNN on the same, medians of 5 alternating turns, launches [resnet50]'s "
          "12 training steps of 32 on its 13 Winograd convs (serving_launches its 4 requests); "
          "K2, K2-bwd and K3 at U-Net's 15 Winograd convs: the 15 convs of one batch of 4 at 512 x 512, each "
          "timed on operands of its own, on channels-last operands, library "
          "cuDNN on the same, medians of 5 alternating turns, launches [unet]'s 8 training steps of 4 "
          "(serving_launches its 4 requests of 4, validation_launches its validation of 16 images, fused_ the "
          "FusedTrainer's and FusedCalculator's); K2 at Inception-BN: its two Winograd convs at batch 32, launches "
          "[inception]'s 4 requests of 32; K1 at Inception-BN's and Inception-v3's fc1: (32, 1024) x (1024, 1000) "
          "and (32, 2048) x (2048, 1008) bf16, launches [inception]'s 4 requests of 32 on each net; "
          "K1 at the IMDB sentiment nets' heads: (32, 128) x (128, 1) of the LSTM and of the BiLSTM, (32, 50) x (50, "
          "250) and (32, 250) x (250, 1) of the 1-d CNN, f32, together, launches (sequence_launches) [imdb-rnn]'s 4 "
          "training steps of 32 of each of the three nets on the hand route, fused_sequence_launches the "
          "FusedTrainer's, validation_launches and fused_validation_launches their validations of 128 rows; "
          "K2 at MiniYolo's, OpenPose COCO's and OpenPose MPI's convs: each net's Winograd convs (12, 15 and 12) at "
          "its batch (16 at 448 x 448, 8 at 368 x 368), each timed on operands of its own, on channels-last "
          "operands, library cuDNN on the same, medians of 5 alternating turns, launches [zoo-vision]'s 4 requests "
          "(fused_launches the FusedCalculator's); K1 at MiniYolo's fc25-fc27: (16, 50176) x (50176, 512), (16, "
          "512) x (512, 4096) and (16, 4096) x (4096, 1470) bf16 together, launches [zoo-vision]'s 4 requests of "
          "16 (launches_wgmma those on wgmma: fc27 takes WMMA); K1 at SentiNet's head: (64, 300) x (300, 2) f32, "
          "launches [sentinet]'s preset run on the hand route (3 epochs of training and validation), "
          "optimizer_launches the six optimizers' 4 steps of 64 each on the eager hand route, "
          "fused_optimizer_launches on FusedTrainer; "
          "K2, K2-bwd and K3 at SegNet's 20 Winograd convs: the 20 convs of one batch of 4 at 360 x 480, each "
          "timed on operands of its own at the extent the forward gives it, on channels-last operands, library "
          "cuDNN on the same, medians of 5 alternating turns, launches [segnet]'s 4 training steps of 4 "
          "(serving_launches its 4 requests of 4, fused_ the FusedTrainer's and FusedCalculator's); "
          "K1 at AlexNet's fc6-fc8: (128, 9216) x (9216, 4096), (128, 4096) x (4096, 4096) and (128, 4096) x "
          "(4096, 1000) f32 together (gemmF32), launches [alexnet]'s 4 training steps of 128 (serving_launches its 4 "
          "requests of 128, fused_ the FusedTrainer's and FusedCalculator's); K1 at C3D's fc6-fc8: (16, 8192) x "
          "(8192, 4096), (16, 4096) x (4096, 4096) and (16, 4096) x (4096, 487) bf16 together, launches [c3d]'s 4 "
          "training steps of 16 (launches_wgmma those on wgmma: fc8 takes WMMA); "
          "K1 at the MoE trunk's products: one forward's 4 trunk products (128, 64) x (64, 64) and 16 expert "
          "products (64, 64) x (64, 64) f32 (gemmF32), launches [moe]'s 4 training steps of 128 (serving_launches "
          "its 4 requests of 128, fused_ the FusedTrainer's and FusedCalculator's); graph_launches and "
          "graph_serving_launches on the ResNet-50 entries: [graph-pass]'s toGraph of ResNet-50, 4 steps and 4 "
          "requests of 32; avg_pool_serving_launches on the first K1 and K2 entries: [vgg-avg]'s VGG-16 with "
          "average pooling, 4 requests of 32; data_launches on K1 at LeNet's shapes: [data]'s epoch of 60000 "
          "parsed MNIST images in chunks of 10000 straight into trainFromHost (data_serial_launches through the "
          "threaded Serial, data_validation_launches its validation of 10000), on K1 at the IMDB nets' heads: "
          "[data]'s 8 steps of 32 parsed rows of the LSTM; "
          "testlib_launches on the first K1 entry: all of [testlib]'s K1 launches (the digits scripts, encodertrain, "
          "both transformertrain routes and optimizenet); optimizenet_launches on the first K1, K2, K2-bwd and K3 "
          "entries: [testlib]'s optimizenet.main(16, looplength=3) in bf16, eager and fused calls; "
          "transformertrain_launches on K1 at the transformer's shapes, K4, K5a and K5b: [testlib]'s epoch of "
          "transformertrain on the flash route in bf16 (transformertrain_xla_launches its f32 xla route's); "
          "driver_launches on the first K1, K1-int8, the first K2 and K4 entries: [engine-driver]'s first runs of "
          "the VGG-16 int8 and bf16 engines and the flash engine through the native driver, one request each; "
          "checkpoint_serving_launches on the first K1 and K2 entries: [ckpt]'s VGG-16 rebuilt from its blueprint and "
          "loaded, 4 requests of 32; checkpoint_launches and checkpoint_fused_launches on K1 at LeNet's shapes: "
          "[ckpt]'s 8 resumed steps of 128, eager and through FusedTrainer; grid_node_launches on K1 at LeNet's "
          "shapes: each of [grid]'s two nodes' 100 training steps of 64, grid_mesh_launches its one-rank mesh step's "
          "20 steps of 128 through FusedStep(mesh=...); mp_node_launches on K1 at the MoE trunk's products: each "
          "of [model-parallel]'s four ranks' 24 pipelined training steps of 128 (its stage's products on 32-row "
          "microbatches, experts at 16 rows) with 2 validation forwards, mp_validation_launches each rank's last "
          "validation forward's, mp_ms (mp_plain_ms, mp_library_ms, mp_bound_ms) the products of one stage forward "
          "on a microbatch, (32, 64) x (64, 64) and 4 x (16, 64) x (64, 64), max_abs_err there including them, "
          "mp_expert_launches each rank's SwitchMoE.distributedForward (one expert); mp_tp_launches and "
          "mp_zero_launches on K1 at LeNet's shapes: [model-parallel]'s tensor-parallel and ZeRO fused steps, 20 "
          "steps of 128 each on a one-rank NCCL mesh; "
          "max_abs_err: largest |kernel - plain| at those shapes")
    print("[time] chip_smoke.py: %.1f s" % (time.perf_counter() - started))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
