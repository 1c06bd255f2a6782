#!/usr/bin/env python3
"""Smoke run of the PyTorch port (contrastyou_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. a CUDA card is present; print its name and power limit (nvidia-smi);
2. build the hand-written kernels from ``contrastyou_tpu_torch/ops/csrc``
   (one nvcc per source, started together);
3. every conv kernel (K1-K3) against its plain PyTorch version on the card,
   at the shapes the main paths give it (forward and dx, batch 5 and 10 of
   ``semi``, batch 36 of ACDC and 96 of prostate pretraining), bf16, with
   kernel, plain and library
   (cuDNN bf16 channels-last convolution) times from CUDA events;
4. the SupCon kernels (D1 ``supcon_loss``, D2 ``supcon_dz``) against their
   plain versions at M = 36, 96, 180, 256 and 480 anchors, d = 256,
   partition and identity masks, f32 with TF32 off, two launches bitwise
   equal; each timed as the wrapper's eager call (``ms``) and on the
   device alone (``device_ms``: CUDA events around the replay of a CUDA
   graph of 20 launches); then (4b) the route: ``sup_con_loss`` value and
   gradient, fused (D1 + D2) against eager, at 2N = 36 to 4096, wall time
   of synchronized eager calls and graph-replayed device time, one line per
   size and mask kind and the sizes where the fused form is no slower on
   both counts;
5. the backward kernels (C1 ``conv_dw_taps``, C2 ``conv3x3_bwd_fused``)
   against their plain versions at the shapes of the paths' backward (C1:
   Conv1.conv0 and the Up2 parity taps; C2: the seven convs with Cin >= 8, a
   skip conv as one launch per input), at batch 96 (prostate) with kernel,
   plain, library (one cuDNN ``convolution_backward``, bf16 channels-last)
   and bound times, then at batches 5, 10 (semi) and 36 (ACDC) with kernel,
   library and bound times beside the einsum form (``conv3x3_dw`` /
   ``upconv3x3_dtaps``, plus K1's dx for C2) that the JAX package's XLA path
   takes there; at every batch C2 also beside the split form on the port's
   own kernels (K1 dx on the flipped kernel + C1 dk), and both kernels
   twice on the same inputs, bitwise equal;
6. the full-width U-Net (max_channel 512, 224x224, 4 classes) on random
   weights: its kernel-path levels against the same levels on the plain
   versions at batch 5 and at batch 96 (the backward takes C1/C2 at both),
   then warm-up and timed ``semi`` + consistency steps (5
   labeled + 5 unlabeled slices) through ``build_cached_train_step`` on a
   device-resident synthetic split; losses finite, parameters changed,
   K1, C1 and C2 launched as often per step as the path implies (16, 4 and
   18), K2 and K3 launched;
7. ``pretrain_decoder`` (config/base + pretrain + hooks/infonce: InfoNCE on
   Conv5 by partition and on Up_conv2 by self, 18-slice contrastive batches,
   36 images per forward) and ``pretrain`` (hooks/infonce_encoder) at full
   width through ``build_pretrain_run``: the hook losses of one batch through
   D1 against the plain SupCon, then warm-up and timed steps; losses finite,
   trainable parameters changed, frozen layers (``_Deconv_1x1``; every
   decoder layer for ``pretrain``) bit-unchanged, D1 and D2 launched once
   per hook per step, C1/C2 as often as the path implies (decoder: 2 and 9
   per step, encoder: 1 and 3);
8. the same two trainers with ``-o Data.name=prostate`` (2 classes, 8
   partitions, random 48-slice batches, 96 images per forward, colour
   jitter 0.1): the same checks, the dense hook's 480 anchors through D1
   against the plain SupCon too, with D1/D2 once per hook per step (the
   route takes every count the card measured no slower fused, phase 4b)
   and C1/C2 as often as the path implies (decoder: 2 and 9 per step,
   encoder: 1 and 3);
9. the dense-IIC kernels (E1 ``iic_joints``, E2 ``iic_joints_bwd``) against
   their plain versions at the Up_conv2 taps of ``semi``'s unlabeled batch
   (f1, f2 [5, 224, 224, 32] bf16, 5 subheads of 20 clusters) at paddings 1
   (the udaiic hook's), 0 and 2 (run right after phase 4); E2 on a random
   cotangent and on the dense hook's own (the gradient of 0.05 x the summed
   IIC losses of E1's raw joints), E1 twice at padding 1 (bitwise equal),
   each bound on its split-bf16 tensor-core arithmetic beside the FP32-core
   figure of the arithmetic its earlier body used;
10. ``semi`` with the udaiic hooks (config/base + hooks/udaiic: IIC on Conv5
   and, at padding 1, on Up_conv2 through E1/E2, plus consistency) through
   ``build_semi_run(UDAIIC_CONFIG)`` at full width: the dense hook's loss on
   one batch through E1 against the plain version, then warm-up and timed
   steps; every hook loss finite, model and head parameters changed, E1 and
   E2 once per step, K1-K3, C1 and C2 as often per step as on ``semi``,
   D1/D2 never (run right after phase 6);
11. the experiment loop (run right after phase 10): a synthetic ACDC
   layout written with the port's PNG writer at 256x256 (8 train and 6
   validation scans of 10 slices, one validation scan of 13) in a temporary
   directory, then ``main.main`` at full width: 2 epochs x 10 host-fed steps
   with validation and test over whole scans, checkpoints and inference on
   ``best`` (``semi/loop``), then a resume to a third epoch on the device
   cache with TTA inference (``semi/loop/resume``); the files, three finite
   storage rows, finite dice, the launches the loop implies (its eval
   forwards' under ``semi/loop/eval``: 8 K1 and 1 K2 each, four a TTA
   batch); train ms/step inside the loop (host-fed and device-cached), eval
   and inference ms per scan (with and without TTA), checkpoint save ms and
   peak memory; then the ragged eval batch (13 slices) through the trained
   weights in eval mode, one pass and TTA's flips, every K1 and K2 launch
   against its plain version;
12. the pretrain -> fine-tune chain (``run_chain``);
13. the mean-teacher family (run right after phase 11): ``main.main``
   with ``Trainer.name=mt`` on phase 11's layout, 2 epochs x 10 host-fed
   steps with validation and test on the teacher, inference on ``best``,
   a resume to a third epoch on the device cache (``mt/loop``): the files,
   finite rows and dice, every eval pass on the teacher, the teacher apart
   from the student, the launches the loop implies (24 K1, 3 K2, 2 K3, 4
   C1, 18 C2 a step); ``ft`` with EvalEMAParameters for one epoch
   (``ft/ema``): ``ema_step`` the steps taken, eval on the EMA; then 2+5
   full-width MT, UAMT and ICT steps through ``build_semi_run`` (ms/step
   beside ``semi``'s, launches, peak memory: forwards 3 / 7 / 5 of 8 K1
   and 1 K2 each, two backward passes each) and each hook's loss of one
   step through the kernels against ``plain_kernels()``, both against f32
   (MT also with ``update_bn``, its teacher in eval mode), every K1 and K2
   call checked against its plain version by call site: the teacher in
   train mode, in eval mode, with frozen statistics (UAMT's noisy passes,
   ICT's second), ICT's student pass over the 10 mixed images;
14. self-paced and superpixel InfoNCE and the resize datasets on disk (run
   after phase 12): one data root in a temporary directory with an
   ``acdc_superpixel`` layout (12 train and 2 validation ACDC scans of 6
   slices at 224x224, maps from ``generate_superpixels``, one process per CPU), a
   spleen archive (512x512) and a prostate archive (256-384 px, 8
   partitions), all written by the port; (14a) one full-width ``semi`` step
   at spleen's 256x256 crop with every K1-K3, C1 and C2 launch held against
   its plain version; (14b) D1/D2 against their plain versions on the pair
   code of a superpixel batch (180 anchors, the positions of one
   superpixel id positives across slices); (14c) ``main.main`` at full
   width for 2 epochs x 10 host-fed steps on each path of ``P14_PATHS``:
   ``spinfonce`` (config/hooks/spinfonce.yaml's section, begin = end = 100,
   soft), ``superpixel`` (``pretrain_decoder`` with
   infonce_dense_superpixel.yaml's section), ``spleen/semi`` (1 epoch with
   validation, test and inference), ``prostate/pretrain_decoder`` (48-slice
   batches read and resized from disk) and ``semi/superpixel`` (the dense
   hook under ``semi``): the files, finite ``storage.csv`` values
   (``sp_weight`` in (0, 1] and ``age_param`` 100 on ``spinfonce``), the
   launches per step of ``P14_LAUNCHES`` plus 8 K1 and 1 K2 an eval forward,
   and ms/step inside the loop;
15. the simple hooks, MixUp and the cross-correlation block (run after
   phase 14): an ACDC layout (12 train and 2 validation scans of 6 slices
   at 224x224) in a temporary directory; (15a) MixUp's extra forward at
   full width (5 labeled slices and their second view, mixed: batch 10,
   running statistics left alone) and its backward with every K1, K2, K3,
   C1 and C2 launch held against its plain version, and an ``ft`` step with
   the hook ending with the BN running statistics of the step without it,
   bit for bit, and a ``semi/simple`` step with the orthogonal hook and one
   without it from the same weights, batch and draws, whose Deconv_1x1
   gradients differ by the hook's weight times the plain gradient of its
   loss; (15b) ``pretrain_cc``'s Conv5 InfoNCE hook (36 anchors)
   through D1 against the plain SupCon; (15c) ``main.main`` at full width
   for 2 epochs x 10 host-fed steps on each path of ``P15_PATHS``:
   ``semi/simple`` (entmin + pseudolabel + orthogonal + dae under ``semi``;
   the DAE conv and Deconv_1x1 must move), ``mixup`` (``Trainer.name=
   mixup``), ``semi/ccblocks`` (ccblocks2.yaml's section), ``pretrain_cc``
   (``pretrain_decoder`` with infonce_encoder.yaml's and ccblocks2.yaml's
   sections) and ``pretrain_clusters`` (ccblocks_imsat.yaml's; the logged
   imsat weight must move between epochs): the files, finite
   ``storage.csv`` values, the launches per step of ``P15_LAUNCHES`` plus 8
   K1 and 1 K2 an eval forward, and ms/step inside the loop;
16. the differentiable mean teacher, multicore and the adversarial trainer
   (run after phase 15): (16a) the double backward at full width: first
   the backward of each Function it runs (ops/convblock.py ``_Conv3x3``,
   ``_ConvDw`` on the 3x3 and Up2 taps, ``_Conv3x3Bwd``, ``_UpconvDx``) at
   the U-Net's batch-5 shapes, through the kernels against
   ``plain_kernels()`` on identical bf16 inputs and cotangents, each output
   to its kernel's tolerance, with the launches each must make; then the
   Hessian-vector product of DMT ``second_order``'s inner loss (sup + 0.1
   MSE, labeled and transformed batches of 5 at 224x224), driven through
   the hook's own ``virtual_teacher``, through the kernels, under
   ``plain_kernels()`` and in f32: held to the plain bf16 product within
   ``HV_PLAIN_RTOL`` and as ``HV_FACTOR`` says, over the whole product and
   at each kernel-backed level (Conv1, Conv2, Up2, Up_conv3, Up_conv2),
   none of which may be zero, with the launches of each kernel in the
   hook's create-graph pass and in the backward of the backward; (16b) one
   full-width step of ``mt``, ``method2``, ``method3`` and ``method4``
   through ``build_semi_run`` after one warm-up: finite losses, the
   launches of ``DMT_PASSES``, a teacher that moved; (16c) ``main.main`` on
   phase 15's layout for 2 epochs x 10 host-fed steps on each path of
   ``P16_PATHS`` (``dmt``, ``dmt/second_order``, ``multicore``,
   ``multicore_mt``, ``adv``): the files JAX's trainers write (no
   ``inference_result.json`` for ``adv``), finite ``storage.csv`` values,
   the launches per step of ``P16_LAUNCHES`` plus 8 K1 and 1 K2 an eval
   forward, the DMT teacher moved, ``adv``'s checkpoint holding the
   segmenter's initial weights (as JAX's does), ms/step and peak memory;
17. the other architectures and the step and optimizer knobs (run after
   phase 16): (17a) the GroupNorm U-Net's kernel levels (phase 6a's stage
   check, ``norm="groupnorm"``: per-sample group statistics from K1/K2's
   sums and their per-sample cotangent through C1/C2) at batches 5 and 15,
   then one full-width ``semi`` step each of the GroupNorm net, of
   ``two_stage=false`` (K1 at batch 15) and of the ResUNet with every K1,
   K2, K3, C1 and C2 launch held against its plain version; (17b) one
   warm-up and one timed full-width ``semi`` step of each of adam, adamw
   and sgd under ``poly`` and ``step``; (17c) UNet2 at its default width
   (dim 16, batch 10, 224x224, f32), a timed forward + backward on cuDNN
   and einsums, no hand kernel; (17d) ``main.main`` on phase 15's layout
   for 2 epochs x 10 host-fed steps on each path of ``P17_PATHS``
   (``resunet/semi``, ``resunet/pretrain_decoder``, ``groupnorm/semi``,
   ``semi/accumulate``, ``semi/one_stage``): the files, finite
   ``storage.csv`` values, what each path must hold (residual blocks, no
   running statistics, one inner update per 2 steps), the launches per
   step of ``P17_LAUNCHES`` plus each eval forward's (``P17_EVAL``),
   ms/step and peak memory;
18-19. data parallelism (run after phase 17), one harness (``run_dp``)
   for every path of ``P19_PATHS``: phase 18's ``semi/dp`` (consistency
   and the encoder InfoNCE hook, Conv5 by partition), then phase 19's
   hooks and trainers beyond ``semi`` (``mt/dp``, ``uamt/dp`` with 2 noisy
   passes, ``ict/dp``, ``semi/udaiic/dp``, ``semi/dense/dp`` with dense and
   self-paced InfoNCE on Up_conv2, ``ft/dp`` with the EMA eval model),
   each at full width through ``build_semi_run(data_group=...)`` on
   ``DP_WORLD`` ranks of ``DP_BATCH`` + ``DP_BATCH`` slices, spawned once
   after the kernels are built (each rank runs the paths in turn; NCCL
   with a card a rank, else gloo with every rank on ``cuda:0``, which
   stages each collective through host memory; the backend and the ranks'
   devices are printed): per path ``DP_STEPS`` steps, the first one's loss,
   the model's and the hooks' gradients and the hooks' states after it
   (teachers, EMA) against f32 (plain kernels) within ``STAGE_FACTOR``
   times the one process's error at the global batch plus ``STAGE_ATOL``
   (as accurate as bf16 against f32), the ranks' parameters and hook
   states bitwise equal after the steps, every rank's launches of
   ``P19_LAUNCHES`` (D1/D2 on ``semi/dp``'s gathered 2N anchors and on
   ``semi/dense/dp``, E1/E2 on ``semi/udaiic/dp``), ms/step on the ranks
   and in one process, and on ``semi/dp`` the time of one all-reduce of
   the gradient bucket and of one BatchNorm's sums;
20. the rest of data parallelism, in the same spawn and under the same
   gates (``P20_PATHS``): ``semi/ccblocks/dp`` (cc, rr and imsat on
   Up_conv2), ``mixup/dp``, ``multicore/dp``, ``dmt/dp`` (``method1``) and
   ``dmt/second_order/dp`` through ``build_semi_run`` at ``DP_BATCH`` +
   ``DP_BATCH`` slices a rank, and ``pretrain/dp``, ``pretrain_cc/dp`` and
   ``pretrain_decoder/prostate/dp`` through ``build_pretrain_run``, the
   one-process contrastive batch (ACDC's 18 slices, prostate's 48) cut
   over the ranks; every rank's launches of ``P20_LAUNCHES`` and its
   collectives a step (all-reduces and all-gathers counted on the rank),
   and the ratio of the ranks' hook-state error to the one process's
   (the block's ``imsat_weight``, the DMT teacher and its Adam moments);
21. experiment tooling and run observability (run after phase 20), on
   phase 11's layout in a temporary directory: ``generate_experiments``
   makes the ``udaiic`` grid (``--labeled-scans 1``: 2 commands) and the
   ``infonce_ed_pretrain`` chain (``--chain-ft``: a pretrain job, then an
   ``ft`` job per ratio of opt/acdc.yaml, 1, 2, 4 and 174), and
   ``SlurmSubmitter(on_local=True)`` runs them with bash as
   ``python -m contrastyou_tpu_torch.main -p config/... -o ...`` processes
   at full width, each job's output in a log file; the only cuts
   (``P21_*``): 2 epochs x 10 steps, ``+Trainer.profile=true`` on the first
   grid command, 4 scans a pretrain batch, and of the chain's ft jobs the
   first (ratio 1) alone. Per run: its files, every numeric
   ``storage.csv`` cell in its TensorBoard events under JAX's tag
   (``read_events``, float32), its launches against its steps and eval
   forwards, its seconds in ``run_experiment``, train ms/step (the profiled
   epoch marked) and the events file's size and write time per epoch, all
   from the run's ``launches.json`` (its launch counts and the trainer's
   ``timing`` records); the
   profiled epoch's Chrome trace, each hand kernel's device events (by
   CUDA function name) equal to the launch counter over the same window and
   to what the epoch's steps and eval forwards imply; ``report`` over the
   runs, one row per finished ``semi`` / ``ft`` run with its best epoch and
   value as its ``storage.csv`` has them;
22. the last modules (run after phase 21): (22a) the cluster-plot entry as
   a ``python -m contrastyou_tpu_torch.plot_pretrain_cluster -p
   config/base.yaml config/hooks/udaiic.yaml -o
   DiscreteMIConsistencyParams.feature_names=[Up_conv2]
   DiscreteMIConsistencyParams.mi_weights=[0.05]`` process at full width, 2
   epochs x 10 steps of decoder pretraining on a 256x256 layout of 12
   train scans (the 6-scan, 18-slice contrastive batch) and 18 validation
   scans (8 dumped batches): its files, ``cluster_acc`` in [0, 1], a
   bijective mapping, the t-SNE PNG decoded, the launches of its training
   and of its dump against its steps and forwards, the t-SNE's size,
   seconds and exact KL; (22b) E1/E2 against their plain versions at that
   path's [18, 224, 224, 32] taps (padding 1); (22c) the documented udaiic
   preset (a pooled ``Conv5`` head) refused before training; (22d) the
   monitor pass on ``pretrain_decoder``: model, BN statistics, heads, hook
   states and the optimizer bitwise unchanged, its launches; (22e) the
   host-fed ``semi`` loop's train epochs with ``prefetch=4`` and without,
   beside the device cache, in turns (ms/step of each; the host-fed
   batches identical); (22f) ``fast_crop`` against the numpy crop and
   scale, exact, and its slices/s at 32 x 224^2 on 8 threads beside the
   dataset's item path;
23. ``Trainer.unroll_steps`` = 8 (the JAX bench's ``UNROLL``): K train
   steps a call, one CUDA graph a call (``engine/graph.py``). Each path of
   ``P23_PATHS`` (``semi`` + consistency device-cached and host-fed through
   pinned memory, ``semi/udaiic`` with E1/E2 in the graph, ``mt`` and
   ``ict`` with the EMA teacher updated in place) runs from one seed as 24
   eager steps at K = 1 and as 3 calls at K = 8 (the eager warm-up, the
   capture and its replay, a replay): losses and every state tensor within
   ``KERNEL_RTOL`` (the state's difference in units of what the steps
   changed; bitwise expected, and printed, where the step has no
   nondeterministic op: ``semi/udaiic``'s eager runs part from each other
   as far as the graph's, PR 24),
   each step's draws those of the eager step and found in the graph's
   input buffers at its replay, the two replays' draws apart, each step's
   learning rate the schedule's, launches equal to the eager run's and 3x
   a graph's; ms/step of the last call against the last 8 eager steps
   (CUDA events), the capture's seconds, peak memory, and on ``semi`` the
   device's busy share of a replay and of 8 eager steps (torch.profiler);
   then ``main -p config/base.yaml config/hooks/consistency.yaml -o
   Trainer.unroll_steps=8 Trainer.device_cache=true`` for 2 epochs of 16
   steps on phase 11's layout: ``.success``, two finite storage rows, C1
   and C2 launched as 32 ``semi`` steps imply. ``python3 chip_smoke.py
   unroll [kind ...]`` runs the same check on other trainers
   (``P23_EXTRA``: ``ft``, ``uamt``, ``mixup``, ``multicore``, ``dmt``,
   ``dmt/second_order``, ``ccblocks``); phase 23 also drives DMT's ``mt``
   and ``method2``-``method4`` rules;
24. chunked evaluation: 44 validation scans of 8-20 slices at
   full width (one chunk of 32 batches and one padded to 32), three
   ``Trainer.eval_epoch`` passes each for ``semi`` (after a K = 8 train
   epoch, its eval graph in the train graph's memory pool), ``mt`` (its
   teacher) and ``multicore``: one capture, launches 2 x 32 x (8 K1 + 1
   K2) a pass, every replayed chunk bit for bit its eager run (losses,
   counts, per-scan DSC), ms a scan against the eager chunks and the
   per-scan path, peak and reserved memory (a pool of its own against the
   train graph's); then 2 gloo ranks on the card: ``semi/dp`` device-cached
   and host-fed, ``mt/dp`` and ``dmt/dp`` at K = 8 bit for bit K = 1 (a
   loop on ranks), and the sharded chunked eval against one process's, two
   collectives a chunk. ``python3 chip_smoke.py eval`` runs phase 24 alone.

Every launch count is set to 0 just before a path is driven and read just
after. The line before the last is the kernels' JSON record: ``launches``
counted on the kernel's own main path (K1-K3, C1, C2: ``semi``; D1/D2:
``pretrain_decoder``; E1/E2: ``semi/udaiic``; ``launches_by_path`` has every
path, the loops' included, and ``mt``, ``uamt``, ``ict``, ``mt/loop``,
``ft/ema``, the five of phases 14 and 15, phases 16's and 17's each,
the seven of phases 18 and 19 and the eight of phase 20, rank 0's, and
phase 21's six runs, ``p21/...``, read from each process's
``launches.json``),
``max_abs_err`` the largest over the checked shapes and call sites (phases
14-17's included),
``ms`` /
``plain_ms`` / ``library_ms`` / ``bound_ms`` the sums over those shapes of
one launch each (C1/C2: over the batch-96 shapes only; ``by_batch`` has the
sums at every checked batch, beside the einsum form's below 96 and, for C2,
the split form's; D1/D2: over M = 36, 180 and 256, with ``device_ms``
beside ``ms`` and every anchor count in ``by_anchors``, D1's record also
holding the route sweep; E1/E2: at padding 1, with every padding in
``by_padding``); ``bound_ms`` is
max(bytes / 3.35 TB/s, operations / peak) with the bf16 tensor peak (989
TFLOP/s) for the conv kernels and for E1 and E2 (their useful FLOP times the
fewest products of bf16 pieces their splits need, ``e1_split_flops``,
``e2_split_flops``) and the f32 peak (67 TFLOP/s) for SupCon. The last line
is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import subprocess
import sys
import time

#: tolerance of a kernel against its plain version, in units of the largest
#: magnitude of the plain output: both accumulate in f32 in different orders
#: and round once to bf16, so they may differ by one bf16 ulp (<= 2^-7 of
#: the value) where a rounding flips; allow two
KERNEL_RTOL = 2.0 ** -6
#: per-sample BN sums of the rounded output: f32 sums over <= 50k pixels in
#: another order, plus the rare one-ulp flips above
STATS_RTOL = 1e-3
#: conv-block stages: the kernel path's distance to f32 may be at most this
#: factor times the plain bf16 path's (two independent bf16 roundings of the
#: same computation), plus STAGE_ATOL of the largest value
STAGE_FACTOR = 2.0
STAGE_ATOL = 1e-2
#: C1 / C2 weight gradients against their plain versions, in units of the
#: largest |dk|: both f32, sums of up to 4.8M exact bf16 products in other
#: orders (the kernel's ~10^5 serial in one accumulator per block)
DK_RTOL = 1e-3
WARMUP_STEPS = 3
TIMED_STEPS = 10
PRETRAIN_WARMUP, PRETRAIN_TIMED, ENCODER_STEPS = 2, 5, 3
PROSTATE_WARMUP, PROSTATE_TIMED, PROSTATE_ENCODER_STEPS = 1, 3, 3
#: SupCon kernels against their plain versions (both f32, sums in another order)
SUPCON_LOSS_RTOL = 1e-5
SUPCON_DZ_TOL = 1e-4
#: the card's peaks (H100 SXM data sheet): HBM bytes/s, bf16 tensor and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
#: E1's raw joints against the plain version, in units of the largest |raw|:
#: both are f32 sums over 250,880 pixel pairs per displacement in other
#: orders, of softmaxes whose exp may differ from torch's by an ulp
IIC_RAW_RTOL = 1e-4
#: the dense hook's loss through E1 against the plain version: the min-shift
#: normalization divides the joints' distances from their minimum, which
#: magnifies the raw joints' relative error
IIC_LOSS_RTOL = 1e-3
#: E1/E2 shapes: the Up_conv2 taps of semi's 5 unlabeled slices, 5 subheads
#: of 20 clusters (config/hooks/udaiic.yaml), the udaiic padding first
IIC_SHAPE, IIC_S, IIC_K, IIC_PADDINGS = (5, 224, 224, 32), 5, 20, (1, 0, 2)
UDAIIC_WARMUP, UDAIIC_TIMED = 3, 5
#: wall ms per step of the paths timed in this call (phase 13 prints its
#: steps beside semi's)
STEP_MS: dict = {}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _add_bound(rec: dict, ms: float, by: str) -> None:
    """Sum a shape's bound into a kernel's record; ``bound_by`` names the
    kind (bytes or operations) that contributes most to the sum."""
    parts = rec.setdefault("_bound_parts", {"bytes": 0.0, "operations": 0.0})
    parts[by] += ms
    rec["bound_ms"] = sum(parts.values())
    rec["bound_by"] = max(parts, key=parts.get)


def _rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


# (name, cin, cskip, cout, H, stats) of every K1 call on the main paths at 224x224
K1_SHAPES = [
    ("Conv1.conv0", 1, 0, 32, 224, True), ("Conv1.conv1", 32, 0, 32, 224, True),
    ("Conv2.conv0", 32, 0, 64, 112, True), ("Conv2.conv1", 64, 0, 64, 112, True),
    ("Up_conv3.conv0", 64, 64, 64, 112, True), ("Up_conv3.conv1", 64, 0, 64, 112, True),
    ("Up_conv2.conv0", 32, 32, 32, 224, True), ("Up_conv2.conv1", 32, 0, 32, 224, True),
    # dx passes: cotangent channels -> input channels, no statistics
    ("dx 32->32", 32, 0, 32, 224, False), ("dx 64->32", 64, 0, 32, 112, False),
    ("dx 64->64", 64, 0, 64, 112, False),
]
#: batches of the conv kernels: semi (5 labeled, 10 unlabeled + transformed),
#: pretraining (two views of 18 slices; prostate: of 48)
CONV_BATCHES = (5, 10, 36, 96)
#: (name, cin, cskip, cout, H) of every C2 conv of the prostate decoder path
#: at 224x224 (C1 takes Conv1.conv0, 1 -> 32 at 224^2, and the Up2 taps,
#: 64 -> 32 at 112^2 -> 224^2)
C2_SHAPES = [
    ("Conv1.conv1", 32, 0, 32, 224), ("Conv2.conv0", 32, 0, 64, 112),
    ("Conv2.conv1", 64, 0, 64, 112), ("Up_conv3.conv0", 64, 64, 64, 112),
    ("Up_conv3.conv1", 64, 0, 64, 112), ("Up_conv2.conv0", 32, 32, 32, 224),
    ("Up_conv2.conv1", 32, 0, 32, 224),
]
#: the batch of the prostate path (C1 / C2 records) and the batches where
#: C1 / C2 are set beside the einsum form (semi's 5 and 10, ACDC's 36)
BWD_BATCH, EINSUM_BATCHES = 96, (5, 10, 36)


def transpose_kernel(taps):
    """Parity taps [4, 4, Cin, Cout] of K2 -> the [Cin, Cout, 4, 4] kernel of
    the stride-2, padding-1 transposed convolution that computes the same
    function (K3's adjoint is the stride-2 convolution with it): output
    parity a, tap r sits at kernel row 3 - a - 2r (columns alike)."""
    import torch
    cin, cout = taps.shape[2:]
    w = torch.empty(cin, cout, 4, 4, dtype=taps.dtype, device=taps.device)
    for p in range(4):
        a, b = divmod(p, 2)
        for t in range(4):
            r, c = divmod(t, 2)
            w[:, :, 3 - a - 2 * r, 3 - b - 2 * c] = taps[p, t]
    return w


def library_calls(x, w, skip=None, w_skip=None, taps=None, g=None):
    """The one cuDNN call (bf16, channels-last) computing each kernel's
    function, as the yardstick of its time: K1 a 3x3 convolution (over the
    pre-built channel concat when there is a skip), K2 the stride-2 transposed
    convolution, K3 the stride-2 convolution. -> (fn, result as NHWC)."""
    import torch
    import torch.nn.functional as F

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    if taps is not None:
        k = transpose_kernel(taps).contiguous(memory_format=torch.channels_last)
        if g is None:
            fn = lambda: F.conv_transpose2d(nchw(x), k, stride=2, padding=1)  # noqa: E731
        else:
            fn = lambda: F.conv2d(nchw(g), k, stride=2, padding=1)  # noqa: E731
    else:
        if skip is not None:
            x, w = torch.cat([skip, x], -1), torch.cat([w_skip, w], 2)
        k = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        fn = lambda: F.conv2d(nchw(x), k, padding=1)  # noqa: E731
    return fn, fn().permute(0, 2, 3, 1)


def check_kernels(device) -> dict:
    """Phase 3: each conv kernel vs its plain version at the main-path
    shapes. Returns one record per kernel (errors maxed, times summed over
    the shapes) and prints one line per shape."""
    import torch
    from contrastyou_tpu_torch.ops import convblock as cb

    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bound_by="") for k in CONV_KERNELS}

    def record(kernel, label, got, ref, fns, work, stats=None, library=None):
        """``fns``: (kernel, plain, library) callables; ``work``: (bytes, flops)."""
        err, rel = _rel_err(got, ref)
        torch.cuda.synchronize()
        ms, pms, lms = (_time_ms(f) for f in fns)
        bms, by = _bound(*work, BF16_FLOPS)
        line = (f"  {kernel:16s} {label:26s} max_abs_err {err:.3e} (rel {rel:.2e}) "
                f"kernel {ms:.4f} ms plain {pms:.4f} ms cudnn {lms:.4f} ms bound {bms:.4f} ms")
        ok = rel <= KERNEL_RTOL and got.shape == ref.shape
        lib_rel = _rel_err(library, ref)[1]
        line += f" cudnn rel {lib_rel:.2e}"
        ok = ok and lib_rel <= KERNEL_RTOL
        if stats is not None:
            for s_got, s_ref in stats:
                srel = _rel_err(s_got, s_ref)[1]
                line += f" stats rel {srel:.2e}"
                ok = ok and srel <= STATS_RTOL
        print(line)
        if not ok:
            raise AssertionError(f"{kernel} {label}: kernel (or its cuDNN yardstick) "
                                 "disagrees with its plain version")
        r = recs[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        _add_bound(r, bms, by)

    for B in CONV_BATCHES:
        for name, cin, cs, cout, H, stats in K1_SHAPES:
            x = randn(B, H, H, cin)
            w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * (cin + cs)))
            skip = randn(B, H, H, cs) if cs else None
            ws = randn(3, 3, cs, cout, scale=1 / math.sqrt(9 * (cin + cs))) if cs else None
            got = cb.conv3x3_stats(x, w, skip, ws, stats=stats)
            ref = cb.conv3x3_stats_plain(x, w, skip, ws, stats=stats)
            lib_fn, lib = library_calls(x, w, skip, ws)
            px = B * H * H
            work = (2 * (px * (cin + cs + cout) + 9 * (cin + cs) * cout)
                    + (8 * B * cout if stats else 0), 2 * px * 9 * (cin + cs) * cout)
            record("conv3x3_stats", f"{name} B={B}", got[0], ref[0],
                   (lambda: cb.conv3x3_stats(x, w, skip, ws, stats=stats),
                    lambda: cb.conv3x3_stats_plain(x, w, skip, ws, stats=stats), lib_fn),
                   work, list(zip(got[1:], ref[1:])) if stats else None, lib)
        # Up2: 64 -> 32 channels, 112^2 -> 224^2
        x = randn(B, 112, 112, 64)
        taps = cb.parity_taps(randn(3, 3, 64, 32, scale=1 / math.sqrt(9 * 64)))
        px = B * 224 * 224
        work = (2 * (px // 4 * 64 + 16 * 64 * 32 + px * 32) + 8 * B * 32,
                2 * px * 4 * 64 * 32)
        got = cb.upconv3x3_stats(x, taps)
        ref = cb.upconv3x3_stats_plain(x, taps)
        lib_fn, lib = library_calls(x, None, taps=taps)
        record("upconv3x3_stats", f"Up2 B={B}", got[0], ref[0],
               (lambda: cb.upconv3x3_stats(x, taps), lambda: cb.upconv3x3_stats_plain(x, taps),
                lib_fn), work, list(zip(got[1:], ref[1:])), lib)
        gy = randn(B, 224, 224, 32)
        got = cb.upconv3x3_dx(gy, taps)
        ref = cb.upconv3x3_dx_plain(gy, taps)
        lib_fn, lib = library_calls(None, None, taps=taps, g=gy)
        record("upconv3x3_dx", f"Up2 dx B={B}", got, ref,
               (lambda: cb.upconv3x3_dx(gy, taps), lambda: cb.upconv3x3_dx_plain(gy, taps),
                lib_fn), (work[0] - 8 * B * 32, work[1]), library=lib)
    return recs


def library_bwd_calls(x, g, w=None, skip=None, w_skip=None, up2=False):
    """The one cuDNN call (``aten.convolution_backward``, bf16, channels-last)
    computing C1's or C2's function, as the yardstick of its time: C1 asks it
    for the weight gradient only (Up2: of the stride-2 transposed convolution
    whose 4x4 kernel holds the parity taps), C2 for the input and weight
    gradients of the conv (over the channel concat for a skip conv). -> (fn,
    result in the kernel's layout: C1 dk [T, Cin, Cout]; C2 (dx NHWC, dk
    HWIO), skip channels first)."""
    import torch

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    cout = g.shape[-1]
    cl = torch.channels_last
    if up2:
        cin = x.shape[-1]
        k = torch.zeros(cin, cout, 4, 4, dtype=x.dtype, device=x.device).contiguous(memory_format=cl)
        fn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), k, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [False, True, False])
        gk = fn()[1]
        return fn, torch.stack([gk[:, :, 3 - a - 2 * r, 3 - b - 2 * c]
                                for a in (0, 1) for b in (0, 1) for r in (0, 1) for c in (0, 1)])
    fused = w is not None
    if skip is not None:
        x, w = torch.cat([skip, x], -1), torch.cat([w_skip, w], 2)
    if not fused:
        w = torch.zeros(3, 3, x.shape[-1], cout, dtype=x.dtype, device=x.device)
    k = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    fn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        nchw(g), nchw(x), k, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [fused, True, False])
    gx, gk, _ = fn()
    dk = gk.permute(2, 3, 1, 0)
    return fn, (dk.reshape(9, *dk.shape[2:]) if gx is None else (gx.permute(0, 2, 3, 1), dk))


def check_bwd_kernels(device) -> dict:
    """Phase 5: C1 and C2 vs their plain versions at the shapes of the paths'
    backward, each launched twice (bitwise equal). Records: errors maxed
    over every batch, times of the batch-96 shapes summed (one step of the
    prostate decoder path); ``by_batch`` holds each batch's sums (kernel,
    cuDNN and bound; plain at 96, the einsum form below it; for C2 the split
    form on the port's own kernels). Prints one line per shape."""
    import torch
    from contrastyou_tpu_torch.ops import convblock as cb

    g = torch.Generator(device=device).manual_seed(4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bound_by="", by_batch={}) for k in BWD_KERNELS}

    def dk_rel(got, ref):
        err, rel = _rel_err(got, ref)
        if not rel <= DK_RTOL or got.shape != ref.shape:
            raise AssertionError(f"dk rel {rel:.2e} > {DK_RTOL}")
        return err, rel

    def twice(label, fn):
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{label}: two launches on the same inputs differ")
        return first

    def c1(B, label, x, gy, up2, einsum):
        (got,) = twice(f"C1 {label}", lambda: (cb.conv_dw_taps(x, gy, up2),))
        ref = cb.conv_dw_taps_plain(x, gy, up2)
        err, rel = dk_rel(got, ref)
        ms = _time_ms(lambda: cb.conv_dw_taps(x, gy, up2))
        px = x.numel() // x.shape[-1]
        T = 16 if up2 else 9
        work = (2 * (x.numel() + gy.numel()) + 4 * got.numel(), 2 * px * T * x.shape[-1] * gy.shape[-1])
        lib_fn, lib = library_bwd_calls(x, gy, up2=up2)
        lrel = _rel_err(lib, ref)[1]
        lms = _time_ms(lib_fn)
        if lrel > KERNEL_RTOL:
            raise AssertionError(f"C1 {label}: the cuDNN yardstick disagrees with plain")
        bms, by = _bound(*work, BF16_FLOPS)
        t = dict(ms=ms, library_ms=lms, bound_ms=bms, bound_by=by, err=err)
        if B == BWD_BATCH:
            t["plain_ms"] = _time_ms(lambda: cb.conv_dw_taps_plain(x, gy, up2), iters=5)
        else:
            t["einsum_ms"] = _time_ms(einsum)
        print(f"  conv_dw_taps     {label:26s} max_abs_err {err:.3e} (rel {rel:.2e}) kernel "
              f"{ms:.4f} ms cudnn {lms:.4f} ms bound {bms:.4f} ms ({by}) cudnn rel {lrel:.2e} "
              + (f"plain {t['plain_ms']:.4f}" if B == BWD_BATCH else f"einsum {t['einsum_ms']:.4f}")
              + " ms")
        return t

    def c2(B, label, x, w, gy, skip, ws, einsum):
        ms = split = plain = err = rel = xrel = 0.0
        fused = [(x, w)] + ([(skip, ws)] if skip is not None else [])
        refs = []
        for xi, wi in fused:
            dx, dk = twice(f"C2 {label}", lambda: cb.conv3x3_bwd_fused(xi, wi, gy))
            pdx, pdk = cb.conv3x3_bwd_fused_plain(xi, wi, gy)
            e, r = dk_rel(dk, pdk)
            ex, xr = _rel_err(dx, pdx)
            if xr > KERNEL_RTOL:
                raise AssertionError(f"C2 {label}: dx rel {xr:.2e} > {KERNEL_RTOL}")
            err, rel, xrel = max(err, e, ex), max(rel, r), max(xrel, xr)
            refs.append((pdx, pdk))
            ms += _time_ms(lambda: cb.conv3x3_bwd_fused(xi, wi, gy))
            wt = cb.flip_transpose(wi)
            split += _time_ms(lambda: (cb.conv3x3_stats(gy, wt, stats=False), cb.conv_dw_taps(xi, gy)))
            if B == BWD_BATCH:
                plain += _time_ms(lambda: cb.conv3x3_bwd_fused_plain(xi, wi, gy), iters=5)
        lib_fn, (ldx, ldk) = library_bwd_calls(x, gy, w, skip, ws)
        pdx = torch.cat([r[0] for r in refs[::-1]], -1)
        pdk = torch.cat([r[1] for r in refs[::-1]], 2)
        lrel = max(_rel_err(ldx, pdx)[1], _rel_err(ldk, pdk)[1])
        lms = _time_ms(lib_fn)
        if lrel > KERNEL_RTOL:
            raise AssertionError(f"C2 {label}: the cuDNN yardstick disagrees with plain")
        cin = sum(xi.shape[-1] for xi, _ in fused)
        px = x.numel() // x.shape[-1]
        work = (2 * (2 * px * cin + px * gy.shape[-1] + 9 * cin * gy.shape[-1])
                + 4 * 9 * cin * gy.shape[-1], 2 * 2 * px * 9 * cin * gy.shape[-1])
        bms, by = _bound(*work, BF16_FLOPS)
        t = dict(ms=ms, library_ms=lms, bound_ms=bms, bound_by=by, err=err, split_ms=split)
        if B == BWD_BATCH:
            t["plain_ms"] = plain
        else:
            t["einsum_ms"] = _time_ms(einsum)
        print(f"  conv3x3_bwd_fused {label:25s} max_abs_err {err:.3e} (dk rel {rel:.2e}, dx "
              f"rel {xrel:.2e}) kernel {ms:.4f} ms cudnn {lms:.4f} ms split (K1 dx + C1) "
              f"{split:.4f} ms bound {bms:.4f} ms ({by}) cudnn rel {lrel:.2e} "
              + (f"plain {plain:.4f} ms" if B == BWD_BATCH else
                 f"einsum+K1 dx {t['einsum_ms']:.4f} ms"))
        return t

    for B in (BWD_BATCH, *EINSUM_BATCHES):
        results = []
        x = randn(B, 224, 224, 1)
        gy = randn(B, 224, 224, 32, scale=1e-2)
        results.append(("conv_dw_taps", c1(B, f"Conv1.conv0 B={B}", x, gy, False,
                                           lambda: cb.conv3x3_dw(x, gy))))
        xu = randn(B, 112, 112, 64)
        results.append(("conv_dw_taps", c1(B, f"Up2 taps B={B}", xu, gy, True,
                                           lambda: cb.upconv3x3_dtaps(xu, gy))))
        for name, cin, cs, cout, H in C2_SHAPES:
            x, gy = randn(B, H, H, cin), randn(B, H, H, cout, scale=1e-2)
            w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * (cin + cs)))
            skip = randn(B, H, H, cs) if cs else None
            ws = randn(3, 3, cs, cout, scale=1 / math.sqrt(9 * (cin + cs))) if cs else None

            def einsum(x=x, w=w, gy=gy, skip=skip, ws=ws):
                for xi, wi in [(x, w)] + ([(skip, ws)] if skip is not None else []):
                    cb.conv3x3_stats(gy, cb.flip_transpose(wi), stats=False)
                    cb.conv3x3_dw(xi, gy)

            results.append(("conv3x3_bwd_fused", c2(B, f"{name} B={B}", x, w, gy, skip, ws,
                                                    einsum)))
            del x, gy, skip
        sums = {k: {} for k in recs}
        for k, t in results:
            r = recs[k]
            r["max_abs_err"] = max(r["max_abs_err"], t["err"])
            for key in ("ms", "library_ms", "bound_ms", "plain_ms", "einsum_ms", "split_ms"):
                if key in t:
                    sums[k][key] = sums[k].get(key, 0.0) + t[key]
            if B == BWD_BATCH:
                r["ms"] += t["ms"]
                r["plain_ms"] += t["plain_ms"]
                r["library_ms"] += t["library_ms"]
                _add_bound(r, t["bound_ms"], t["bound_by"])
        for k, agg in sums.items():
            recs[k]["by_batch"][f"B={B}"] = agg
            print(f"  {k} B={B} over the path's shapes: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in agg.items()))
        torch.cuda.empty_cache()
    return recs


#: anchor counts of phase 4: the pretrain paths' (36: ACDC's encoder hook, 2 x
#: 18; 96: prostate's, 2 x 48; 180: ACDC's dense hook, 2 x 18 x 5 points; 480:
#: prostate's, 2 x 48 x 5) and 256, the old gate's largest. The records' sums
#: are over SUPCON_SUMMED, the shapes every earlier run summed.
SUPCON_ANCHORS, SUPCON_SUMMED = (36, 96, 180, 256, 480), (36, 180, 256)
#: phase 4b: the fused form against the eager one, value and gradient
ROUTE_ANCHORS = (36, 96, 180, 256, 480, 960, 2048, 4096)


def _graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms of one ``fn()``: CUDA events around the replay of a CUDA
    graph that holds ``launches`` calls, over ``launches``; the median of
    ``replays`` replays. The host's launch cost is out of it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[replays // 2]


def _wall_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Host ms of one ``fn()`` as an eager caller feels it: the host clock
    around ``iters`` calls that end in a synchronize; the median of ``reps``."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return sorted(times)[reps // 2]


def supcon_inputs(M: int, masks: str, device, g, d: int = 256):
    """Normalized z [M, d] and the pair code of two views of M / 2 items:
    partition labels (3 partitions) or identity (self) masks."""
    import torch
    from contrastyou_tpu_torch.losses.contrastive import (_expand_masks,
                                                          pair_masks_from_target)
    from contrastyou_tpu_torch.ops import supcon
    n = M // 2
    z = torch.nn.functional.normalize(torch.randn(M, d, generator=g, device=device), dim=1)
    target = torch.arange(n, device=device) % 3 if masks == "partition" else None
    code = supcon.pair_code(*_expand_masks(
        *pair_masks_from_target(target, n, device=device), n))
    return z, code, target


def check_supcon(device) -> dict:
    """Phase 4: D1 and D2 vs their plain versions (f32, TF32 off) at
    SUPCON_ANCHORS, d = 256, partition labels and identity (self) masks; two
    launches of each bitwise equal. Per shape the wrapper's time (``ms``,
    CUDA events around eager calls, host launch cost included) and the
    kernel's device time (``device_ms``, graph replay); the records sum both
    over SUPCON_SUMMED and keep every anchor count in ``by_anchors``."""
    import torch
    from contrastyou_tpu_torch.ops import supcon

    g = torch.Generator(device=device).manual_seed(2)
    recs = {k: dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=None,
                    bound_ms=0.0, bound_by="", by_anchors={}) for k in supcon.LAUNCHES}
    tau, d = 0.07, 256
    for M in SUPCON_ANCHORS:
        for masks in ("partition", "self"):
            z, code, _ = supcon_inputs(M, masks, device, g, d)
            got = supcon.supcon_loss(z, code, tau)
            ref = supcon.supcon_loss_plain(z, code, tau)
            loss_rel = abs(float(got[0].mean() - ref[0].mean())) / abs(float(ref[0].mean()))
            vec_err, vec_rel = _rel_err(got[0], ref[0])
            gs = torch.ones(1, device=device)
            dz = supcon.supcon_dz(z, code, got[1], got[2], gs, tau)
            dz_ref = supcon.supcon_dz_plain(z, code, ref[1], ref[2], gs, tau)
            dz_err, dz_rel = _rel_err(dz, dz_ref)
            again = supcon.supcon_loss(z, code, tau)
            twice = (all(torch.equal(a, b) for a, b in zip(got, again))
                     and torch.equal(dz, supcon.supcon_dz(z, code, got[1], got[2], gs, tau)))
            torch.cuda.synchronize()
            d1 = lambda: supcon.supcon_loss(z, code, tau)
            d2 = lambda: supcon.supcon_dz(z, code, got[1], got[2], gs, tau)
            times = {
                "supcon_loss": (_time_ms(d1), _graph_ms(d1),
                                _time_ms(lambda: supcon.supcon_loss_plain(z, code, tau)),
                                _bound(M * d * 4 + M * M + 12 * M, 2 * M * M * d, F32_FLOPS),
                                vec_err),
                "supcon_dz": (_time_ms(d2), _graph_ms(d2),
                              _time_ms(lambda: supcon.supcon_dz_plain(z, code, ref[1], ref[2],
                                                                      gs, tau)),
                              _bound(8 * M * d + M * M + 8 * M + 4, 4 * M * M * d, F32_FLOPS),
                              dz_err)}
            print(f"  supcon M={M:3d} {masks:9s} loss rel {loss_rel:.2e} (per anchor "
                  f"{vec_rel:.2e}) dz max_abs_err {dz_err:.3e} (rel {dz_rel:.2e}), twice "
                  f"bitwise {twice}; " + "; ".join(
                      f"{k} wrapper {t[0]:.4f} ms device {t[1]:.4f} ms plain {t[2]:.4f} ms "
                      f"bound {t[3][0]:.6f} ms" for k, t in times.items()))
            if loss_rel > SUPCON_LOSS_RTOL or vec_rel > SUPCON_LOSS_RTOL or dz_rel > SUPCON_DZ_TOL:
                raise AssertionError(f"SupCon M={M} {masks}: kernel disagrees with plain")
            if not twice:
                raise AssertionError(f"SupCon M={M} {masks}: two launches differ")
            for k, (ms, dms, pms, (bms, by), err) in times.items():
                r = recs[k]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                agg = r["by_anchors"].setdefault(
                    f"M={M}", {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0})
                for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                               ("bound_ms", bms)):
                    agg[key] += v
                if M in SUPCON_SUMMED:
                    r["ms"] += ms
                    r["device_ms"] += dms
                    r["plain_ms"] += pms
                    _add_bound(r, bms, by)
    return recs


def route_sweep(device) -> dict:
    """Phase 4b: ``sup_con_loss`` value and gradient in z, fused (D1 + D2)
    against eager (``fused=False``), on the same views, d = 256, at
    ROUTE_ANCHORS with partition and self masks: the wall time of eager calls
    (host clock, synchronized) and the device time (graph replay). Returns
    the sizes at which the fused form was no slower on both counts (both
    mask kinds), and the rows."""
    import torch
    from contrastyou_tpu_torch.losses.contrastive import sup_con_loss

    g = torch.Generator(device=device).manual_seed(4)
    rows, fused_wins, tau = [], [], 0.07
    for M in ROUTE_ANCHORS:
        wins = True
        for masks in ("partition", "self"):
            z, _, target = supcon_inputs(M, masks, device, g)

            def step(fused):
                # fresh leaves a call: their autograd nodes take the stream
                # of the call (a graph capture's, in _graph_ms)
                f1, f2 = (v.detach().requires_grad_() for v in z.chunk(2))
                loss = sup_con_loss(f1, f2, target=target, temperature=tau, fused=fused)
                return (loss.detach(), *torch.autograd.grad(loss, (f1, f2)))

            (lf, *gf), (le, *ge) = step(True), step(False)
            rel = abs(float(lf - le)) / abs(float(le))
            grad_rel = max(_rel_err(a, b)[1] for a, b in zip(gf, ge))
            if rel > SUPCON_LOSS_RTOL * 10 or grad_rel > SUPCON_DZ_TOL:
                raise AssertionError(f"route M={M} {masks}: fused {float(lf)} vs eager "
                                     f"{float(le)}, grad rel {grad_rel:.2e}")
            row = {"anchors": M, "masks": masks,
                   "fused_wall_ms": _wall_ms(lambda: step(True)),
                   "eager_wall_ms": _wall_ms(lambda: step(False)),
                   "fused_device_ms": _graph_ms(lambda: step(True)),
                   "eager_device_ms": _graph_ms(lambda: step(False))}
            rows.append(row)
            wins &= (row["fused_wall_ms"] <= row["eager_wall_ms"]
                     and row["fused_device_ms"] <= row["eager_device_ms"])
            print(f"  route 2N={M:4d} {masks:9s} loss rel {rel:.1e} grad rel {grad_rel:.1e}; "
                  f"fused wall {row['fused_wall_ms']:.4f} ms device "
                  f"{row['fused_device_ms']:.4f} ms; eager wall {row['eager_wall_ms']:.4f} ms "
                  f"device {row['eager_device_ms']:.4f} ms")
        if wins:
            fused_wins.append(M)
    print(f"  route: fused no slower on both counts at 2N = {fused_wins} of {ROUTE_ANCHORS}")
    return {"fused_no_slower_at": fused_wins, "rows": rows}


def iic_work(f: "torch.Tensor", S: int, K: int, padding: int) -> dict:
    """(bytes, flops) of E1 and E2 on features ``f`` [B, H, W, C] (each input
    read once, each output written once; only the S diagonal K x K blocks of
    each displacement's joint): E1 projects both maps (2 * 2N * C * S * K)
    and forms the joints (2 * Td^2 * N * S * K^2); E2 recomputes the
    projections, forms dp for both views (twice the joints' work), then df
    and dW (2 * 2N * C * S * K each)."""
    B, H, W, C = f.shape
    N, SK, td2 = B * H * W, S * K, (2 * padding + 1) ** 2
    fbytes = 2 * f.numel() * f.element_size()
    params, joints = 4 * (C * SK + SK), 4 * S * td2 * K * K
    proj, pair = 2 * 2 * N * C * SK, 2 * td2 * N * S * K * K
    return {"iic_joints": (fbytes + params + joints, proj + pair),
            "iic_joints_bwd": (2 * fbytes + 2 * params + joints, 3 * proj + 2 * pair)}


def e2_split_flops(f: "torch.Tensor", S: int, K: int, padding: int) -> float:
    """bf16 tensor-core FLOP that E2's split needs at the least on bf16
    features ``f`` [B, H, W, C]: each product's useful FLOP (``iic_work``)
    times the products of bf16 pieces it takes (pieces i, j with i + j < the
    larger count): the projection and dW 2 (features exact, W or dz in two
    pieces), df 3 (dz and W in two), dp 3, or 5 at padding 0 where the
    cotangent takes three pieces. Padding K to 24 and the halo's recomputed
    projections are work the kernel issues beyond this."""
    B, H, W, C = f.shape
    N, SK, td2 = B * H * W, S * K, (2 * padding + 1) ** 2
    proj, pair = 2 * 2 * N * C * SK, 2 * td2 * N * S * K * K
    dp_products = 5 if padding == 0 else 3
    return float(2 * proj + dp_products * 2 * pair + 3 * proj + 2 * proj)


def e1_split_flops(f: "torch.Tensor", S: int, K: int, padding: int) -> float:
    """bf16 tensor-core FLOP that E1's split needs at the least on bf16
    features ``f`` [B, H, W, C]: each product's useful FLOP (``iic_work``)
    times the products of bf16 pieces it takes: the projection 3 (features
    exact, W_s in three pieces), the joints 3 (p in two pieces: hi hi + hi
    lo + lo hi). Padding K to 24, the halo's recomputed projections and the
    spare rows of the joints' fragments are work the kernel issues beyond
    this."""
    B, H, W, C = f.shape
    N, SK, td2 = B * H * W, S * K, (2 * padding + 1) ** 2
    proj, pair = 2 * 2 * N * C * SK, 2 * td2 * N * S * K * K
    return float(3 * proj + 3 * pair)


def check_iic(device, shape=IIC_SHAPE, paddings=IIC_PADDINGS) -> dict:
    """Phase 9: E1 and E2 vs their plain versions (f32 math, TF32 off) on
    post-ReLU bf16 feature maps of the Up_conv2 taps' shape, at each padding
    of IIC_PADDINGS; E2 on a random cotangent and on the dense hook's own
    (the gradient of 0.05 x the summed IIC losses of E1's raw joints); E1
    twice on the same inputs at padding 1, bitwise equal. Records: errors
    maxed over the paddings and cotangents, times and bound of padding 1
    (the udaiic hook's), every padding in ``by_padding``. Both bounds are on
    bf16 tensor cores (``e1_split_flops``, ``e2_split_flops``); the line
    also prints each kernel's FP32-core figure, the bound of the arithmetic
    of its earlier body."""
    import torch
    from contrastyou_tpu_torch.losses.discrete_mi import iid_loss_from_raw_joints
    from contrastyou_tpu_torch.ops import iic

    g = torch.Generator(device=device).manual_seed(5)
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                    bound_by="", by_padding={}) for k in iic.LAUNCHES}
    C, S, K = IIC_SHAPE[-1], IIC_S, IIC_K
    f1, f2 = (torch.relu(torch.randn(shape, generator=g, device=device)).to(torch.bfloat16)
              for _ in range(2))
    w = torch.randn(C, S * K, generator=g, device=device) / math.sqrt(C)
    b = torch.randn(S * K, generator=g, device=device) * 0.1
    for pad in paddings:
        kw = dict(num_subheads=S, num_clusters=K, padding=pad)
        raw, raw_ref = iic.iic_joints(f1, f2, w, b, **kw), iic.iic_joints_plain(f1, f2, w, b, **kw)
        err1, rel1 = _rel_err(raw, raw_ref)
        if pad == paddings[0] and not torch.equal(raw, iic.iic_joints(f1, f2, w, b, **kw)):
            raise AssertionError(f"E1 padding {pad}: two launches differ")
        jbar = torch.randn(raw.shape, generator=g, device=device)
        loss_raw = raw.detach().clone().requires_grad_()
        (0.05 * iid_loss_from_raw_joints(loss_raw, padding=pad,
                                         count=math.prod(shape[:3])).sum()).backward()
        rels, bad_dtype = {}, False
        for cot, jb in (("randn", jbar), ("loss", loss_raw.grad)):
            got = iic.iic_joints_bwd(f1, f2, w, b, jb, **kw)
            ref = iic.iic_joints_bwd_plain(f1, f2, w, b, jb, **kw)
            rels[cot] = [_rel_err(a, r) for a, r in zip(got, ref)]
            bad_dtype |= any(a.dtype != r.dtype or a.shape != r.shape for a, r in zip(got, ref))
            del got, ref
        err2 = max(e for rs in rels.values() for e, _ in rs)
        torch.cuda.synchronize()
        times = {"iic_joints": (_time_ms(lambda: iic.iic_joints(f1, f2, w, b, **kw)),
                                _time_ms(lambda: iic.iic_joints_plain(f1, f2, w, b, **kw),
                                         iters=5), err1),
                 "iic_joints_bwd": (_time_ms(lambda: iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)),
                                    _time_ms(lambda: iic.iic_joints_bwd_plain(f1, f2, w, b, jbar,
                                                                              **kw), iters=5),
                                    err2)}
        work = iic_work(f1, S, K, pad)
        split = {"iic_joints": e1_split_flops(f1, S, K, pad),
                 "iic_joints_bwd": e2_split_flops(f1, S, K, pad)}
        bounds = {k: _bound(work[k][0], split[k], BF16_FLOPS) for k in work}
        fp32_ms = {k: _bound(*work[k], F32_FLOPS)[0] for k in work}
        line = f"  iic padding {pad}: E1 raw max_abs_err {err1:.3e} (rel {rel1:.2e})"
        for cot, rs in rels.items():
            line += f"; E2 on the {cot} cotangent " + ", ".join(
                f"{n} rel {r:.2e}" for n, (_, r) in zip(("df1", "df2", "dW", "db"), rs))
        for k, (ms, pms, err) in times.items():
            bms, by = bounds[k]
            line += (f"; {k} kernel {ms:.4f} ms plain {pms:.4f} ms bound {bms:.4f} ms ({by}), "
                     f"FP32-core figure {fp32_ms[k]:.4f} ms")
            r = recs[k]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["by_padding"][str(pad)] = {"ms": ms, "plain_ms": pms, "bound_ms": bms}
            if pad == paddings[0]:
                r.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        print(line)
        if (rel1 > IIC_RAW_RTOL or bad_dtype
                or any(r > KERNEL_RTOL for rs in rels.values() for _, r in rs[:2])
                or any(r > DK_RTOL for rs in rels.values() for _, r in rs[2:])):
            raise AssertionError(f"IIC padding {pad}: a kernel disagrees with its plain version")
        del raw_ref
        torch.cuda.empty_cache()
    return recs


@contextlib.contextmanager
def plain_iic():
    """Route the IIC wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import iic
    saved = iic.iic_joints, iic.iic_joints_bwd
    iic.iic_joints, iic.iic_joints_bwd = iic.iic_joints_plain, iic.iic_joints_bwd_plain
    try:
        yield
    finally:
        iic.iic_joints, iic.iic_joints_bwd = saved


def check_iic_hook(run) -> None:
    """Phase 10a: the dense IIC hook's loss on one unlabeled batch and its
    transformed copy (one forward, no statistics update) through E1 against
    the same loss through the plain version."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.engine.steps import sample_step_draws
    from contrastyou_tpu_torch.models.projectors import DenseClusterHead
    from contrastyou_tpu_torch.ops.affine import transform_image

    gen = torch.Generator(device=run.unlabeled_cache.device).manual_seed(3)
    n = run.batch_slices // 2
    x = run.unlabeled_cache.sample(gen, n)["image"]
    draws = sample_step_draws(gen, n)
    hooks = [h for h in run.hooks if isinstance(getattr(h, "projector", None), DenseClusterHead)]
    taps = tuple(h.taps[0] for h in hooks)
    with torch.no_grad():
        _, feats = run.state.model(torch.cat([x, transform_image(x, draws.geo, draws.gammas)]),
                                   taps=taps, update_stats=False)
        ctx = StepContext(unlabeled_taps={k: v[:n] for k, v in feats.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in feats.items()},
                          geo_params=draws.geo,
                          bundle=ModelBundle(run.state.model, tuple(x.shape[1:])))
        for h in hooks:
            got = float(h.loss(ctx, {})[0])
            with plain_iic():
                ref = float(h.loss(ctx, {})[0])
            rel = abs(got - ref) / abs(ref)
            print(f"  {h.name}: loss through E1 {got:.7f}, plain {ref:.7f} (rel {rel:.2e})")
            if not math.isfinite(got) or rel > IIC_LOSS_RTOL:
                raise AssertionError(f"{h.name}: E1 loss {got} vs plain {ref}")


def run_udaiic(device, card: str, semi: dict) -> dict:
    """Phase 10b: warm-up + timed full-width semi steps with the udaiic
    hooks; ``semi``: the launches of phase 6b's semi run."""
    import torch
    from contrastyou_tpu_torch.main import UDAIIC_CONFIG, build_semi_run

    run = build_semi_run(UDAIIC_CONFIG, device=device)
    print(f"semi/udaiic: hooks {[(h.name, h.weight) for h in run.hooks]}")
    check_iic_hook(run)
    tensors = dict(run.state.model.named_parameters())
    tensors.update({f"{h.name}/{k}": p for h in run.hooks if isinstance(h, torch.nn.Module)
                    for k, p in h.named_parameters()})
    before = {k: v.detach().clone() for k, v in tensors.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(UDAIIC_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(UDAIIC_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    keys = [f"{h.name}/loss" for h in run.hooks] + ["sup_loss", "total_loss"]
    losses = [{k: round(float(m[k]), 6) for k in keys} for m in metrics]
    moved = [k for k in tensors if not torch.equal(before[k], tensors[k].detach())]
    ms = dt / UDAIIC_TIMED * 1e3
    print(f"semi/udaiic: {UDAIIC_WARMUP}+{UDAIIC_TIMED} steps, losses {losses}")
    print(f"semi/udaiic: {len(moved)}/{len(tensors)} parameter tensors changed; "
          f"launches {launches}")
    print(f"semi/udaiic: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite loss: {losses}")
    for part in ["_"] + [f"{h.name}/" for h in run.hooks if isinstance(h, torch.nn.Module)]:
        if not any(k.startswith(part) for k in moved):
            raise AssertionError(f"no parameter of {part!r} changed")
    steps, semi_steps = UDAIIC_WARMUP + UDAIIC_TIMED, WARMUP_STEPS + TIMED_STEPS
    if (launches["iic_joints"] != steps or launches["iic_joints_bwd"] != steps
            or any(launches[k] * semi_steps != semi[k] * steps for k in CONV_KERNELS + BWD_KERNELS)
            or any(launches[k] for k in SUPCON_KERNELS)):
        raise AssertionError(f"launches {launches}: want E1/E2 {steps} each, K1-K3, C1 and C2 "
                             f"per step as on semi ({semi}), D1/D2 none")
    return launches


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import convblock as cb
    names = (*CONV_KERNELS, *BWD_KERNELS)
    saved = [getattr(cb, k) for k in names]
    for k in names:
        setattr(cb, k, getattr(cb, k + "_plain"))
    try:
        yield
    finally:
        for k, f in zip(names, saved):
            setattr(cb, k, f)


def check_stages(device, B: int, norm: str = "batchnorm") -> None:
    """Phase 6a: the kernel-path U-Net levels (Conv1; Up2 -> Up_conv2 with
    the Conv1 skip) at full width, batch ``B``, forward and backward, are as
    close to an f32 evaluation of the same modules as the plain bf16 path is
    (the backward runs C1 twice and C2 four times at every batch); ``norm``
    ``groupnorm`` checks the GroupNorm net's levels (phase 17a).
    bf16 itself moves these gradients by 10-25% from f32 (measured on the CPU:
    the BN backward cancels large terms), so a direct kernel-vs-plain bound
    would be noise; the kernel path must instead stay within
    ``STAGE_FACTOR`` times the plain path's own distance to f32."""
    import torch
    from contrastyou_tpu_torch.models.unet import UNet

    gen = torch.Generator(device=device).manual_seed(1)
    net = UNet(max_channel=512, momentum=0.01, norm=norm).to(device).init_weights(gen)
    net32 = UNet(max_channel=512, momentum=0.01, norm=norm, dtype=torch.float32).to(device)
    net32.load_state_dict(net.state_dict())
    x = torch.rand(B, 224, 224, 1, generator=gen, device=device)
    d3 = torch.randn(B, 112, 112, 64, generator=gen, device=device).to(torch.bfloat16)
    proj = torch.randn(B, 224, 224, 32, generator=gen, device=device)

    def run(model):
        model.zero_grad(set_to_none=True)
        d = d3.to(model.dtype).clone().requires_grad_()
        e1 = model._Conv1(x)
        out = model._Up_conv2(model._Up2(d), skip=e1)
        (out.float() * proj).mean().backward()
        res = {"out": out.detach(), "d Up2 input": d.grad}
        res.update({k: p.grad.clone() for k, p in model.named_parameters()
                    if p.grad is not None})
        return res

    _reset_counts()
    got = run(net)
    launches = _counts()
    with plain_kernels():
        plain, ref = run(net), run(net32)
    worst = 0.0
    for k in ref:
        ek, ep = _rel_err(got[k], ref[k])[1], _rel_err(plain[k], ref[k])[1]
        worst = max(worst, ek / (ep + STAGE_ATOL))
        if ek > STAGE_FACTOR * ep + STAGE_ATOL or not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"{k}: kernel path {ek:.3e} from f32, plain bf16 path {ep:.3e}")
    bwd = [launches[k] for k in BWD_KERNELS]
    if bwd != [2, 4]:
        raise AssertionError(f"stage check B={B}: C1/C2 launches {bwd}")
    print(f"stage check {norm} B={B} (Conv1, Up2, Up_conv2 fwd+bwd, {len(ref)} tensors; C1/C2 "
          f"launches {bwd}): kernel-path error vs f32 at most {worst:.2f}x the plain bf16 "
          f"path's (+{STAGE_ATOL})")


def _reset_counts() -> None:
    from contrastyou_tpu_torch.ops import convblock as cb, iic, supcon
    cb.reset_launch_counts()
    supcon.reset_launch_counts()
    iic.reset_launch_counts()


def _counts() -> dict:
    from contrastyou_tpu_torch.engine.trainer import kernel_launches
    return kernel_launches()


def run_train(device, card: str) -> dict:
    """Phase 6b: warm-up + timed full-width semi + consistency steps."""
    import torch
    from contrastyou_tpu_torch.main import MAIN_PATH_CONFIG, build_semi_run

    run = build_semi_run(MAIN_PATH_CONFIG, device=device)
    before = {k: v.detach().clone() for k, v in run.state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    losses = [float(m["total_loss"]) for m in metrics]
    changed = sum(int(not torch.equal(before[k], v.detach()))
                  for k, v in run.state.model.named_parameters())
    ms = STEP_MS["semi"] = dt / TIMED_STEPS * 1e3
    print(f"train: {WARMUP_STEPS}+{TIMED_STEPS} steps, losses {losses}")
    print(f"train: {changed}/{len(before)} parameter tensors changed; launches {launches}")
    print(f"train: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if changed == 0:
        raise AssertionError("no parameter changed")
    steps = WARMUP_STEPS + TIMED_STEPS
    expect = {k: steps * n for k, n in SEMI_LAUNCHES.items()}
    if (any(launches[k] != v for k, v in expect.items())
            or min(launches[k] for k in CONV_KERNELS) <= 0):
        raise AssertionError(f"launches {launches}: want {expect} and K2, K3 > 0")
    if any(launches[k] for k in IIC_KERNELS):
        raise AssertionError(f"E1/E2 launched without an IIC hook: {launches}")
    return launches


@contextlib.contextmanager
def plain_supcon():
    """Route the SupCon wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import supcon
    saved = supcon.supcon_loss, supcon.supcon_dz
    supcon.supcon_loss, supcon.supcon_dz = supcon.supcon_loss_plain, supcon.supcon_dz_plain
    try:
        yield
    finally:
        supcon.supcon_loss, supcon.supcon_dz = saved


def check_hook_losses(run) -> None:
    """Phase 7a / 8 / 15b: the InfoNCE hook losses of one contrastive batch
    through D1 against the same losses through the plain SupCon, on the same
    forward (other hooks of the run left out)."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.hooks.infonce import INFONCEHook
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.engine.steps import point_grids
    from contrastyou_tpu_torch.trainers.pretrain import sample_pretrain_draws

    gen = torch.Generator(device=run.cache.device).manual_seed(3)
    n = run.batch_slices
    idx = torch.arange(n, device=run.cache.device) % len(run.cache)
    batch = run.cache.sample_at(idx, *run.cache.draw_offsets(gen, n))
    hooks = [h for h in run.hooks if isinstance(h, INFONCEHook)]
    grids = point_grids(hooks)
    draws = sample_pretrain_draws(gen, n, point_grids=grids)
    taps = tuple(h.taps[0] for h in hooks)
    with torch.no_grad():
        x = torch.cat([batch["image"], batch["image"]], 0)
        _, feats = run.state.model(x, until=run.until, taps=taps, update_stats=False)
        ctx = StepContext(unlabeled_taps={k: v[:n] for k, v in feats.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in feats.items()},
                          partition_group=batch["partition"], geo_params=draws.geo,
                          point_draws=draws.points,
                          bundle=ModelBundle(run.state.model, tuple(x.shape[1:])))
        for h in hooks:
            got = float(h.loss(ctx, {})[0])
            with plain_supcon():
                ref = float(h.loss(ctx, {})[0])
            rel = abs(got - ref) / abs(ref)
            print(f"  {h.name}: loss through D1 {got:.6f}, plain {ref:.6f} (rel {rel:.2e})")
            if not math.isfinite(got) or rel > SUPCON_LOSS_RTOL * 10:
                raise AssertionError(f"{h.name}: D1 loss {got} vs plain {ref}")


#: launches per step of (D1 and D2 each, C1, C2) on each pretraining path:
#: one D1/D2 pair per hook (36 / 180 anchors on ACDC, 96 / 480 on prostate,
#: all under FUSED_MAX_ANCHORS); C1 for Conv1.conv0 (and Up2's taps), C2 for
#: every other narrow conv input the backward reaches
PRETRAIN_LAUNCHES = {
    ("pretrain_decoder", "acdc"): (2, 2, 9), ("pretrain", "acdc"): (1, 1, 3),
    ("pretrain_decoder", "prostate"): (2, 2, 9), ("pretrain", "prostate"): (1, 1, 3),
}


def run_pretrain(device, card: str, trainer: str, warmup: int, timed: int,
                 data: str = "acdc") -> dict:
    """Phases 7b / 8: full-width pretraining steps through ``build_pretrain_run``."""
    import torch
    from contrastyou_tpu_torch.main import parse_config, build_pretrain_run
    from contrastyou_tpu_torch.models.unet import UNet

    run = build_pretrain_run(parse_config(["-o", f"Trainer.name={trainer}", f"Data.name={data}"]),
                             device=device)
    model = run.state.model
    frozen_layers = UNet.arch_elements[UNet.arch_elements.index(run.until) + 1:]
    trainer = trainer if data == "acdc" else f"{trainer}/{data}"
    print(f"{trainer}: hooks {[h.name for h in run.hooks]}, forward cut at {run.until}, "
          f"frozen {list(frozen_layers)}, batch {run.batch_slices} slices x 2 views, "
          f"{model._Deconv_1x1.out_channels} classes")
    check_hook_losses(run)
    tensors = dict(model.named_parameters())
    tensors.update({f"{h.name}/{k}": p for h in run.hooks for k, p in h.named_parameters()})
    before = {k: v.detach().clone() for k, v in tensors.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(timed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    losses = [{k: round(float(v), 5) for k, v in m.items()} for m in metrics]
    frozen = [k for k in tensors if k.split(".")[0].lstrip("_") in frozen_layers]
    moved = [k for k in tensors if not torch.equal(before[k], tensors[k].detach())]
    ms = dt / timed * 1e3
    print(f"{trainer}: {warmup}+{timed} steps, losses {losses}")
    print(f"{trainer}: {len(moved)}/{len(tensors)} parameter tensors changed "
          f"({len(frozen)} frozen); launches {launches}")
    print(f"{trainer}: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite loss: {losses}")
    if set(moved) & set(frozen) or "_Deconv_1x1.weight" not in frozen:
        raise AssertionError(f"frozen tensors changed: {sorted(set(moved) & set(frozen))}")
    for part in ["_"] + [h.name for h in run.hooks]:
        if not any(k.startswith(part) for k in moved):
            raise AssertionError(f"no parameter of {part!r} changed")
    steps = warmup + timed
    d, c1, c2 = PRETRAIN_LAUNCHES[trainer.split("/")[0], data]
    expect = {"supcon_loss": steps * d, "supcon_dz": steps * d, "conv_dw_taps": steps * c1,
              "conv3x3_bwd_fused": steps * c2, "iic_joints": 0, "iic_joints_bwd": 0}
    if any(launches[k] != v for k, v in expect.items()) or launches["conv3x3_stats"] <= 0:
        raise AssertionError(f"launches {launches}, expected {expect} and K1 > 0")
    if trainer.startswith("pretrain_decoder") and min(launches[k] for k in CONV_KERNELS) <= 0:
        raise AssertionError(f"a conv kernel of the decoder path never launched: {launches}")
    return launches


#: the loop phase: a synthetic ACDC layout at 256 x 256 (8 train and 6
#: validation scans of 10 slices, one validation scan of 13 so an eval batch
#: is ragged), ``semi`` at full width for 2 epochs x 10 steps, then a resume
#: to a third epoch
LOOP_SCANS, LOOP_SLICES, LOOP_LONG, LOOP_SIZE = (8, 6), 10, 13, 256
LOOP_EPOCHS, LOOP_STEPS = 2, 10


class _Timings(logging.Handler):
    """Collects the trainer's ``timing`` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if hasattr(record, "timing"):
            self.records.append(dict(record.timing))


@contextlib.contextmanager
def eval_launches(counts: dict):
    """Add the launches made inside ``Trainer.eval_epoch`` and
    ``SemiTrainer.inference`` to ``counts`` (the loop's eval forwards)."""
    from contrastyou_tpu_torch.engine.trainer import Trainer
    from contrastyou_tpu_torch.trainers.semi import SemiTrainer
    saved = Trainer.eval_epoch, SemiTrainer.inference

    def counting(fn):
        def wrapper(*a, **kw):
            before = _counts()
            try:
                return fn(*a, **kw)
            finally:
                for k, v in _counts().items():
                    counts[k] = counts.get(k, 0) + v - before[k]
        return wrapper

    Trainer.eval_epoch, SemiTrainer.inference = counting(saved[0]), counting(saved[1])
    try:
        yield counts
    finally:
        Trainer.eval_epoch, SemiTrainer.inference = saved


@contextlib.contextmanager
def checked_forward_kernels(errs: dict, site=None):
    """Route K1 and K2 through wrappers that also run the plain version on
    the same inputs and record the largest error relative to the plain
    output's largest magnitude (outputs) and to the largest statistic, by
    kernel name, or by (name, ``site()``) when a call-site function is given."""
    from contrastyou_tpu_torch.ops import convblock as cb
    k1, k2 = cb.conv3x3_stats, cb.upconv3x3_stats

    def record(name, shape, got, ref):
        out = _rel_err(got[0], ref[0])[1]
        stats = max(_rel_err(g, r)[1] for g, r in zip(got[1:], ref[1:])) if got[1] is not None else 0
        key = name if site is None else (name, site())
        worst = errs.setdefault(key, {"out": 0.0, "stats": 0.0, "shapes": set()})
        worst["out"], worst["stats"] = max(worst["out"], out), max(worst["stats"], stats)
        worst["shapes"].add(shape)

    def conv(x, w, skip=None, w_skip=None, stats=True):
        got = k1(x, w, skip, w_skip, stats)
        record("conv3x3_stats", tuple(x.shape), got, cb.conv3x3_stats_plain(x, w, skip, w_skip, stats))
        return got

    def upconv(x, taps):
        got = k2(x, taps)
        record("upconv3x3_stats", tuple(x.shape), got, cb.upconv3x3_stats_plain(x, taps))
        return got

    cb.conv3x3_stats, cb.upconv3x3_stats = conv, upconv
    try:
        yield errs
    finally:
        cb.conv3x3_stats, cb.upconv3x3_stats = k1, k2


def check_eval_kernels(device, data_root, run_dir) -> None:
    """Phase 11b: the loop's ragged eval batch (the 13-slice scan, padded)
    through the trained weights in eval mode, one pass and the four flips
    of TTA: every K1 and K2 launch against its plain version."""
    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint
    from contrastyou_tpu_torch.engine.steps import build_eval_step
    from contrastyou_tpu_torch.main import MAIN_PATH_CONFIG
    from contrastyou_tpu_torch.models.unet import UNet

    loaders = get_data(MAIN_PATH_CONFIG["Data"], {}, {}, root_dir=package.DATA_PATH)
    batch = next(b for loader in loaders[2:] for b in loader if b["mask"].sum() == LOOP_LONG)
    ckpt = load_checkpoint(run_dir / "last", map_location=device)
    model = UNet(max_channel=int(ckpt["host_state"]["config"]["Arch"]["max_channel"]),
                 momentum=0.01).to(device)
    model.load_state_dict(ckpt["train_state"]["model"])
    x, y, mask = (torch.from_numpy(batch[k]).to(device) for k in ("image", "target", "mask"))
    errs: dict = {}
    with checked_forward_kernels(errs):
        for tta in (False, True):
            loss = build_eval_step(ModelBundle(model, (224, 224, 1)), tta=tta)(model, x, y, mask)[0]
            if not math.isfinite(float(loss)):
                raise AssertionError(f"eval loss {float(loss)} (tta={tta})")
    for name, e in errs.items():
        print(f"  {name} eval mode vs plain at {sorted(e['shapes'])}: out {e['out']:.2e} "
              f"(limit {KERNEL_RTOL:.2e}), stats {e['stats']:.2e} (limit {STATS_RTOL:.0e})")
        if e["out"] > KERNEL_RTOL or e["stats"] > STATS_RTOL:
            raise AssertionError(f"{name} in eval mode disagrees with its plain version: {e}")
    if set(errs) != {"conv3x3_stats", "upconv3x3_stats"} or not any(
            s[0] == LOOP_LONG for e in errs.values() for s in e["shapes"]):
        raise AssertionError(f"K1/K2 not checked at the eval batch {LOOP_LONG}: {errs}")


def write_loop_layout(root) -> None:
    """Phase 11's synthetic ACDC layout under ``root``."""
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
    synthesize_acdc_like(root, num_train_scans=LOOP_SCANS[0], num_val_scans=LOOP_SCANS[1],
                         slices_per_scan=LOOP_SLICES, size=LOOP_SIZE)
    synthesize_acdc_like(root, num_train_scans=0, num_val_scans=1, slices_per_scan=LOOP_LONG,
                         size=LOOP_SIZE, first_scan=sum(LOOP_SCANS) + 1, seed=1)


def run_loop(device, card: str) -> dict:
    """Phase 11: the experiment loop through ``main.main``: 2 epochs of 10
    host-fed steps (validation and test over whole scans each epoch,
    checkpoints, inference on ``best``), then a resume to a third epoch on
    the device cache with TTA inference; returns each run's launches and
    the eval forwards' (``semi/loop``, ``semi/loop/resume``,
    ``semi/loop/eval``)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main

    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
            t0 = time.perf_counter()
            data, run_dir = Path(tmp) / "data", Path(tmp) / "runs" / "loop"
            write_loop_layout(data)
            package.DATA_PATH, package.RUN_PATH = str(data), str(Path(tmp) / "runs")
            print(f"loop: wrote {sum(LOOP_SCANS) + 1} scans at {LOOP_SIZE}^2 in "
                  f"{time.perf_counter() - t0:.1f} s")
            argv = ["-o", "Trainer.name=semi", f"Trainer.num_batches={LOOP_STEPS}",
                    "Trainer.save_dir=loop"]
            torch.cuda.reset_peak_memory_stats()
            eval_counts: dict = {}
            by_path = {}
            with eval_launches(eval_counts):
                for path, extra in (("semi/loop", [f"Trainer.max_epoch={LOOP_EPOCHS}"]),
                                    ("semi/loop/resume", [f"Trainer.max_epoch={LOOP_EPOCHS + 1}",
                                                          "Trainer.device_cache=true",
                                                          "+Inference.tta=true"])):
                    _reset_counts()
                    t0 = time.perf_counter()
                    if port_main.main(argv + extra) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                    torch.cuda.synchronize()
                    by_path[path] = _counts()
                    print(f"{path}: {time.perf_counter() - t0:.1f} s; launches {by_path[path]}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            by_path["semi/loop/eval"] = {k: eval_counts.get(k, 0) for k in by_path["semi/loop"]}
            check_loop_outputs(run_dir, timings.records, by_path, card, peak)
            check_eval_kernels(device, data, run_dir)
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path


#: launches per train step of ``semi`` (2 forwards, 2 backward passes)
SEMI_STEP_LAUNCHES = {"conv3x3_stats": 16, "upconv3x3_stats": 2, "upconv3x3_dx": 2,
                      "conv_dw_taps": 4, "conv3x3_bwd_fused": 18}


def check_loop_outputs(run_dir, records: list, by_path: dict, card: str, peak: float,
                       path: str = "semi/loop", per_step: dict = SEMI_STEP_LAUNCHES) -> None:
    """Phase 11a (and 13a): the run's files, three finite storage rows,
    finite dice; the launches the loop implies (``per_step`` a train step,
    on ``semi`` 16 K1, 2 K2, 2 K3, 4 C1, 18 C2; 8 K1 and 1 K2 an eval
    forward, four forwards a TTA batch); the loop's times. ``by_path``
    holds ``path``, ``path/resume`` and ``path/eval``."""
    import json

    for f in ("storage.csv", "config.yaml", ".success", "inference_result.json",
              "last/train_state.pt", "last/host_state.pkl", "best/train_state.pt"):
        if not (run_dir / f).exists():
            raise AssertionError(f"loop: {f} missing")
    rows = (run_dir / "storage.csv").read_text().splitlines()
    header = rows[0].split(",")
    values = [dict(zip(header, r.split(","))) for r in rows[1:]]
    result = json.loads((run_dir / "inference_result.json").read_text())
    dice = [float(v[k]) for v in values for k in v if "/dice/" in k] + list(
        result["dice"].values())
    print(f"{path}: storage rows {[r.split(',')[0] for r in rows[1:]]}, val DSC_mean "
          f"{[float(v['val/eval/dice/DSC_mean']) for v in values]}, inference {result['dice']}")
    if len(values) != LOOP_EPOCHS + 1 or not all(math.isfinite(d) for d in dice):
        raise AssertionError(f"{path}: {len(values)} storage rows, dice {dice}")
    train = [r for r in records if r["phase"] == "train"]
    steps = sum(r["steps"] for r in train)
    forwards = {True: 0, False: 0}
    for r in records:
        if r["phase"] in ("val", "test", "inference"):
            forwards[bool(r.get("tta"))] += r["batches"] * (4 if r.get("tta") else 1)
    fwd = sum(forwards.values())
    for r in train:
        print(f"{path}: train epoch {r['epoch']} ({'device cache' if r['device_cache'] else 'host-fed'}"
              f"): {r['seconds'] / r['steps'] * 1e3:.3f} ms/step inside the loop on {card}")
    for r in records:
        if r["phase"] in ("val", "test", "inference"):
            tta = " with TTA" if r.get("tta") else (" without TTA" if r["phase"] == "inference" else "")
            print(f"{path}: {r['phase']}{tta} epoch {r['epoch']}: {r['batches']} scans, "
                  f"{r['seconds'] / r['batches'] * 1e3:.3f} ms/scan on {card}")
    saves = [r["seconds"] * 1e3 for r in records if r["phase"] == "save"]
    print(f"{path}: checkpoint save {min(saves):.1f}-{max(saves):.1f} ms ({len(saves)} saves) on "
          f"{card}; peak memory {peak:.2f} GiB")
    total = {k: by_path[path][k] + by_path[f"{path}/resume"][k] for k in by_path[path]}
    want = {k: n * steps for k, n in per_step.items()}
    want["conv3x3_stats"] += 8 * fwd
    want["upconv3x3_stats"] += fwd
    want.update({k: 0 for k in SUPCON_KERNELS + IIC_KERNELS})
    want_eval = {"conv3x3_stats": 8 * fwd, "upconv3x3_stats": fwd,
                 **{k: 0 for k in total if k not in ("conv3x3_stats", "upconv3x3_stats")}}
    if total != want or by_path[f"{path}/eval"] != want_eval:
        raise AssertionError(f"{path} launches {total} (eval {by_path[f'{path}/eval']}), want "
                             f"{want} (eval {want_eval}) for {steps} steps, {fwd} eval forwards")


#: the chain phase: a synthetic ACDC layout at 256 x 256 (12 train scans, so
#: the pretrain split holds the 6 scans that ``scan_sample_num`` 6 needs, and
#: 4 validation scans, all of 10 slices); ``pretrain_decoder`` for 2 epochs x
#: 10 steps and a resume to a third, then ``ft`` from its ``last`` for 2 x 10
CHAIN_SCANS, CHAIN_SLICES, CHAIN_SIZE = (12, 4), 10, 256
CHAIN_EPOCHS, CHAIN_STEPS = 2, 10
#: launches per train step of (D1 and D2 each, K1, K2, K3, C1, C2) on each
#: loop of the chain: ``ft`` is one pass of ``semi``'s two (5 labeled slices)
CHAIN_LAUNCHES = {"pretrain_decoder/loop": {"supcon_loss": 2, "supcon_dz": 2,
                                            "conv_dw_taps": 2, "conv3x3_bwd_fused": 9},
                  "ft/loop": {"conv3x3_stats": 8, "upconv3x3_stats": 1, "upconv3x3_dx": 1,
                              "conv_dw_taps": 2, "conv3x3_bwd_fused": 9}}


@contextlib.contextmanager
def warm_start_snapshot(seen: dict):
    """Record the ft trainer's parameters, buffers and optimizer right before
    its first epoch, i.e. right after the ``Arch.checkpoint`` warm start."""
    from contrastyou_tpu_torch.trainers.ft import FineTuneTrainer
    saved = FineTuneTrainer.start_training

    def start(self):
        seen["params"] = {k: p.detach().clone() for k, p in self._model.named_parameters()}
        seen["buffers"] = {k: b.clone() for k, b in self._model.named_buffers()}
        seen["optimizer"] = (len(self._state.optimizer.state), self._state.optimizer.count,
                             self._state.step)
        return saved(self)

    FineTuneTrainer.start_training = start
    try:
        yield seen
    finally:
        FineTuneTrainer.start_training = saved


def check_ft_step(device, config, weights) -> None:
    """Phase 12b: one ``ft`` step (5 labeled slices of the run's loader) on
    the fine-tuned weights, its loss and gradients through the kernels and
    under ``plain_kernels()``: the kernel path's distance to an f32 step may
    be at most ``STAGE_FACTOR`` times the plain bf16 path's plus
    ``STAGE_ATOL`` of the largest value (whole-network bf16 moves these
    gradients by tens of percent from f32 in either path)."""
    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.optim import create_optimizer
    from contrastyou_tpu_torch.engine.steps import build_train_step, init_train_state
    from contrastyou_tpu_torch.models.unet import UNet

    labeled = get_data(config["Data"], config["LabeledLoader"], {}, root_dir=package.DATA_PATH)[0]
    host = next(iter(labeled))
    batch = {"labeled_image": torch.from_numpy(host["image"]).to(device),
             "labeled_target": torch.from_numpy(host["target"]).to(device).long()}

    def step(dtype):
        model = UNet(max_channel=int(config["Arch"]["max_channel"]),
                     momentum=float(config["Arch"]["momentum"]), dtype=dtype).to(device)
        model.load_state_dict(weights)
        bundle = ModelBundle(model, (224, 224, 1))
        opt, _ = create_optimizer(model.parameters(), config["Optim"], config["Scheduler"],
                                  max_epoch=2, steps_per_epoch=CHAIN_STEPS)
        m = build_train_step(bundle, [], mode="ft")(init_train_state(bundle, [], opt), batch, None)
        return {"loss": m["sup_loss"].reshape(1),
                **{k: p.grad.clone() for k, p in model.named_parameters()}}

    _reset_counts()
    got = step(torch.bfloat16)
    launches = _counts()
    with plain_kernels():
        plain, ref = step(torch.bfloat16), step(torch.float32)
    worst, loss_err = 0.0, None
    for k in ref:
        ek, ep = _rel_err(got[k], ref[k])[1], _rel_err(plain[k], ref[k])[1]
        worst = max(worst, ek / (ep + STAGE_ATOL))
        if k == "loss":
            loss_err = (ek, ep)
        if ek > STAGE_FACTOR * ep + STAGE_ATOL or not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"ft step {k}: kernel path {ek:.3e} from f32, plain bf16 {ep:.3e}")
    print(f"chain: one ft step (batch {len(host['image'])}) through the kernels vs plain_kernels(), "
          f"each against f32: loss {loss_err[0]:.2e} vs {loss_err[1]:.2e}; over the loss and "
          f"{len(ref) - 1} gradients the kernel path's error is at most {worst:.2f}x the plain "
          f"bf16 path's (+{STAGE_ATOL}; limit {STAGE_FACTOR}x)")
    want = CHAIN_LAUNCHES["ft/loop"]
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"ft step launches {launches}, want {want}")


def run_chain(device, card: str) -> dict:
    """Phase 12: the contrastive pretrain -> fine-tune chain through
    ``main.main`` at full width: ``pretrain_decoder`` for 2 epochs and a
    resume to a third (``pretrain_decoder/loop``), then ``ft`` with
    ``Arch.checkpoint=<pretrain>/last`` for 2 epochs with validation, test
    and inference (``ft/loop``; its eval forwards also under
    ``ft/loop/eval``). Checks the files, finite losses and dice, the frozen
    ``_Deconv_1x1``, the warm start (parameters bit-equal to the
    checkpoint's, fresh BN buffers and optimizer) and the launches per
    step; then one ft step against ``plain_kernels()`` (phase 12b)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint

    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    by_path, records = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp:
            t0 = time.perf_counter()
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            synthesize_acdc_like(data, num_train_scans=CHAIN_SCANS[0], num_val_scans=CHAIN_SCANS[1],
                                 slices_per_scan=CHAIN_SLICES, size=CHAIN_SIZE)
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            print(f"chain: wrote {sum(CHAIN_SCANS)} scans at {CHAIN_SIZE}^2 in "
                  f"{time.perf_counter() - t0:.1f} s")
            pre_argv = ["-o", "Trainer.name=pretrain_decoder", f"Trainer.num_batches={CHAIN_STEPS}",
                        "Trainer.save_dir=pre"]
            ft_argv = ["-o", "Trainer.name=ft", f"Trainer.num_batches={CHAIN_STEPS}",
                       f"Trainer.max_epoch={CHAIN_EPOCHS}", "Trainer.save_dir=ft",
                       f"Arch.checkpoint={runs / 'pre' / 'last'}"]
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            timings.records.clear()
            t0 = time.perf_counter()
            for epochs in (CHAIN_EPOCHS, CHAIN_EPOCHS + 1):
                if port_main.main(pre_argv + [f"Trainer.max_epoch={epochs}"]) != 0:
                    raise AssertionError("pretrain_decoder/loop: main returned non-zero")
            torch.cuda.synchronize()
            by_path["pretrain_decoder/loop"] = _counts()
            records["pretrain_decoder/loop"] = list(timings.records)
            print(f"pretrain_decoder/loop: {time.perf_counter() - t0:.1f} s; launches "
                  f"{by_path['pretrain_decoder/loop']}")
            seen: dict = {}
            eval_counts: dict = {}
            _reset_counts()
            timings.records.clear()
            t0 = time.perf_counter()
            with warm_start_snapshot(seen), eval_launches(eval_counts):
                if port_main.main(ft_argv) != 0:
                    raise AssertionError("ft/loop: main returned non-zero")
            torch.cuda.synchronize()
            by_path["ft/loop"] = _counts()
            by_path["ft/loop/eval"] = {k: eval_counts.get(k, 0) for k in by_path["ft/loop"]}
            records["ft/loop"] = list(timings.records)
            print(f"ft/loop: {time.perf_counter() - t0:.1f} s; launches {by_path['ft/loop']}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            pre_ckpt = load_checkpoint(runs / "pre" / "last", map_location=device)
            check_chain_outputs(device, runs, pre_ckpt, seen, records, by_path, card, peak)
            ft_ckpt = load_checkpoint(runs / "ft" / "last", map_location=device)
            check_ft_step(device, ft_ckpt["host_state"]["config"], ft_ckpt["train_state"]["model"])
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path


def check_chain_outputs(device, runs, pre_ckpt, seen, records, by_path, card, peak) -> None:
    """Phase 12a: files, rows, finite losses and dice, the frozen layer, the
    warm start, launches per step and the loops' times."""
    import json

    import torch
    from contrastyou_tpu_torch import main as port_main

    pre, ft = runs / "pre", runs / "ft"
    for run, present, absent in ((pre, ("storage.csv", ".success", "last/train_state.pt"),
                                  ("best", "inference_result.json")),
                                 (ft, ("storage.csv", ".success", "last/train_state.pt",
                                       "best/train_state.pt", "inference_result.json"), ())):
        for f in present:
            if not (run / f).exists():
                raise AssertionError(f"chain: {run.name}/{f} missing")
        for f in absent:
            if (run / f).exists():
                raise AssertionError(f"chain: {run.name}/{f} written")
    rows = {}
    for run, n in ((pre, CHAIN_EPOCHS + 1), (ft, CHAIN_EPOCHS)):
        lines = (run / "storage.csv").read_text().splitlines()
        header = lines[0].split(",")
        rows[run.name] = [dict(zip(header, r.split(","))) for r in lines[1:]]
        values = [float(v) if v else math.nan for r in rows[run.name] for k, v in r.items()
                  if "loss" in k or "dice" in k]
        if len(rows[run.name]) != n or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"chain: {run.name} storage rows {rows[run.name]}")
    result = json.loads((ft / "inference_result.json").read_text())
    if not all(math.isfinite(v) for v in list(result["dice"].values()) + [result["loss"]]):
        raise AssertionError(f"chain: ft inference {result}")
    print(f"chain: pretrain reg_loss {[float(r['tra/pretrain/reg_loss/value']) for r in rows['pre']]}; "
          f"ft sup_loss {[float(r['tra/tra/sup_loss/value']) for r in rows['ft']]}, val DSC_mean "
          f"{[float(r['val/eval/dice/DSC_mean']) for r in rows['ft']]}, inference {result['dice']}")

    cfg = pre_ckpt["host_state"]["config"]
    fresh = port_main._model(cfg, device, torch.bfloat16, None,
                             torch.Generator(device=device).manual_seed(int(cfg["RandomSeed"])), 4)
    saved, init = pre_ckpt["train_state"]["model"], fresh.state_dict()
    if not all(torch.equal(saved[k], init[k]) for k in ("_Deconv_1x1.weight", "_Deconv_1x1.bias")):
        raise AssertionError("chain: the frozen _Deconv_1x1 changed in pretraining")
    if torch.equal(saved["_Up_conv2.conv.3.weight"], init["_Up_conv2.conv.3.weight"]):
        raise AssertionError("chain: pretraining left Up_conv2 unchanged")
    params_equal = all(torch.equal(v, saved[k]) for k, v in seen["params"].items())
    buffers_fresh = all(torch.equal(v, init[k]) for k, v in seen["buffers"].items())
    print(f"chain: warm start: {len(seen['params'])} parameter tensors bit-equal to the "
          f"checkpoint's: {params_equal}; {len(seen['buffers'])} BN buffers fresh: "
          f"{buffers_fresh}; optimizer (state entries, count, step) {seen['optimizer']}")
    if not (params_equal and buffers_fresh and seen["optimizer"] == (0, 0, 0)):
        raise AssertionError("chain: the ft warm start is not the checkpoint's parameters "
                             "over fresh BN statistics and a fresh optimizer")

    for path, recs in records.items():
        train = [r for r in recs if r["phase"] == "train"]
        steps = sum(r["steps"] for r in train)
        for r in train:
            print(f"{path}: train epoch {r['epoch']}: {r['seconds'] / r['steps'] * 1e3:.3f} "
                  f"ms/step inside the loop on {card}")
        for r in recs:
            if r["phase"] in ("val", "test", "inference"):
                print(f"{path}: {r['phase']} epoch {r['epoch']}: {r['batches']} scans, "
                      f"{r['seconds'] / r['batches'] * 1e3:.3f} ms/scan on {card}")
        saves = [r["seconds"] * 1e3 for r in recs if r["phase"] == "save"]
        print(f"{path}: checkpoint save {min(saves):.1f}-{max(saves):.1f} ms ({len(saves)} saves) "
              f"on {card}")
        fwd = sum(r["batches"] for r in recs if r["phase"] in ("val", "test", "inference"))
        want = {k: n * steps for k, n in CHAIN_LAUNCHES[path].items()}
        if path == "ft/loop":
            want["conv3x3_stats"] += 8 * fwd
            want["upconv3x3_stats"] += fwd
            want.update({k: 0 for k in SUPCON_KERNELS + IIC_KERNELS})
            want_eval = {k: 0 for k in by_path[path]}
            want_eval.update(conv3x3_stats=8 * fwd, upconv3x3_stats=fwd)
            if by_path["ft/loop/eval"] != want_eval:
                raise AssertionError(f"ft/loop eval launches {by_path['ft/loop/eval']}, "
                                     f"want {want_eval}")
        else:
            want.update({k: 0 for k in IIC_KERNELS})
        got = by_path[path]
        if any(got[k] != n for k, n in want.items()) or min(got[k] for k in CONV_KERNELS) <= 0:
            raise AssertionError(f"{path} launches {got}, want {want} for {steps} steps and "
                                 f"{fwd} eval forwards, every conv kernel > 0")
    print(f"chain: peak memory {peak:.2f} GiB on {card}")


#: phase 13: the mean-teacher family. Overrides of the in-code ``mt`` base
#: that make the UAMT and ICT presets (config/hooks/uamt.yaml, ict.yaml)
MT_OVERRIDES = {
    "mt": [],
    "uamt": ["~MeanTeacherParameters", "+UAMeanTeacherParameters.weight=10",
             "+UAMeanTeacherParameters.alpha=0.99", "+UAMeanTeacherParameters.weight_decay=0.000001",
             "+UAMeanTeacherParameters.update_bn=false", "+UAMeanTeacherParameters.hard_clip=false"],
    "ict": ["~MeanTeacherParameters", "+ICTMeanTeacherParameters.weight=10",
            "+ICTMeanTeacherParameters.alpha=0.99", "+ICTMeanTeacherParameters.weight_decay=0.000001",
            "+ICTMeanTeacherParameters.update_bn=false"],
}
#: (forwards, backward passes) of a train step: the student's two, plus the
#: teacher's one (MT), one clean and four noisy (UAMT), two and the
#: student's mixed pass over both views (ICT). ICT's loss reads no logits
#: of the student's unlabeled pass, so that pass has no backward and the
#: mixed pass's takes its place: two backward passes on every path
MT_PASSES = {"mt": (3, 2), "uamt": (7, 2), "ict": (5, 2)}
MT_WARMUP, MT_TIMED = 2, 5


def mt_step_launches(name: str) -> dict:
    """K1 8 and K2 1 a forward; K3 1, C1 2 and C2 9 a backward pass."""
    f, b = MT_PASSES[name]
    return {"conv3x3_stats": 8 * f, "upconv3x3_stats": f, "upconv3x3_dx": b,
            "conv_dw_taps": 2 * b, "conv3x3_bwd_fused": 9 * b}


def _mt_config(name: str, *extra: str):
    from contrastyou_tpu_torch.main import parse_config
    return parse_config(["-o", "Trainer.name=mt", *MT_OVERRIDES[name], *extra])


@contextlib.contextmanager
def mt_call_sites(stack: list):
    """Name the call site of each forward in ``stack`` while it runs: the
    teacher's (train- or eval-mode BN, running statistics updated or
    frozen) and ICT's student pass over the mixed images."""
    from contrastyou_tpu_torch.hooks import mt
    teacher = mt.MeanTeacherTrainerHook.__dict__["_teacher_apply"]
    ict_loss = mt.ICTMeanTeacherTrainerHook.loss

    def apply(ctx, state, image, **kw):
        stack.append("teacher, " + ("train-mode BN" if kw.get("train") else "eval-mode BN")
                     + ("" if kw.get("update_stats", True) else ", statistics frozen"))
        try:
            return teacher.__func__(ctx, state, image, **kw)
        finally:
            stack.pop()

    def loss(self, ctx, state):
        stack.append("ICT student, mixed views")
        try:
            return ict_loss(self, ctx, state)
        finally:
            stack.pop()

    mt.MeanTeacherTrainerHook._teacher_apply = staticmethod(apply)
    mt.ICTMeanTeacherTrainerHook.loss = loss
    try:
        yield stack
    finally:
        mt.MeanTeacherTrainerHook._teacher_apply = teacher
        mt.ICTMeanTeacherTrainerHook.loss = ict_loss


def check_mt_loss(run, name: str, errs: dict) -> None:
    """Phase 13b: one train step of ``run``'s weights, teacher and hook on
    one batch and its draws, through the kernels (K1 and K2 checked against
    their plain versions at every call, by call site, into ``errs``), under
    ``plain_kernels()`` and in f32: the hook's loss through the kernels is at
    most ``STAGE_FACTOR`` times the plain bf16 path's distance to f32 plus
    ``STAGE_ATOL``."""
    import copy

    import numpy as np
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.optim import create_optimizer
    from contrastyou_tpu_torch.engine.state import TrainState
    from contrastyou_tpu_torch.engine.steps import build_train_step, sample_step_draws
    from contrastyou_tpu_torch.models.unet import UNet

    hook = run.hooks[0]
    model0 = run.state.model
    weights = {k: v.detach().clone() for k, v in model0.state_dict().items()}
    hook_state = copy.deepcopy(run.state.hook_states[hook.name])
    device = model0._Deconv_1x1.weight.device
    gen = torch.Generator(device=device).manual_seed(5)
    lab, unl = run.labeled_cache.sample(gen, 5), run.unlabeled_cache.sample(gen, 5)
    batch = {"labeled_image": lab["image"], "labeled_target": lab["target"],
             "unlabeled_image": unl["image"]}
    draws = sample_step_draws(gen, 5, [hook], host_rng=np.random.default_rng(5),
                              shape=tuple(unl["image"].shape))
    stack: list = []

    def step(dtype):
        model = UNet(max_channel=model0.max_channel, momentum=model0._Conv1.conv[1].momentum,
                     dtype=dtype).to(device)
        model.load_state_dict(weights)
        bundle = ModelBundle(model, tuple(unl["image"].shape[1:]))
        opt, _ = create_optimizer(model.parameters(), {"name": "RAdam", "lr": 1e-7}, {},
                                  max_epoch=1, steps_per_epoch=1)
        state = TrainState(model, opt, {hook.name: copy.deepcopy(hook_state)})
        m = build_train_step(bundle, [hook])(state, batch, draws, 1)
        return {k: m[k].reshape(1) for k in (f"{hook.name}/loss", "sup_loss")}

    with mt_call_sites(stack), checked_forward_kernels(errs, lambda: stack[-1] if stack else
                                                       "student"):
        got = step(torch.bfloat16)
    with plain_kernels():
        plain, ref = step(torch.bfloat16), step(torch.float32)
    for k in ref:
        ek, ep = _rel_err(got[k], ref[k])[1], _rel_err(plain[k], ref[k])[1]
        print(f"  {name}: {k} {float(got[k]):.6e} through the kernels, {float(plain[k]):.6e} "
              f"plain bf16, {float(ref[k]):.6e} f32: error {ek:.2e} vs {ep:.2e}")
        if ek > STAGE_FACTOR * ep + STAGE_ATOL or not math.isfinite(float(got[k])):
            raise AssertionError(f"{name} {k}: kernel path {ek:.3e} from f32, plain bf16 {ep:.3e}")


def run_mt_steps(device, card: str) -> dict:
    """Phase 13b: warm-up and timed full-width steps through
    ``build_semi_run`` in turns, ``semi`` (+ consistency), MT, UAMT, ICT,
    ``semi`` again (launches, ms/step, peak memory above what the process
    held before the run), then each mean-teacher hook's loss through the
    kernels against the plain path and f32 (and MT with ``update_bn``, its
    teacher in eval mode), K1 and K2 checked against their plain versions at
    the teacher's and ICT's call sites."""
    import gc

    import torch
    from contrastyou_tpu_torch.main import MAIN_PATH_CONFIG, build_semi_run

    by_path, errs, semi_ms = {}, {}, []
    for name in ("semi", *MT_PASSES, "semi"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        run = build_semi_run(MAIN_PATH_CONFIG if name == "semi" else _mt_config(name),
                             device=device)
        hook = run.hooks[0]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        metrics = run.run(MT_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics += run.run(MT_TIMED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        steps = MT_WARMUP + MT_TIMED
        ms = dt / MT_TIMED * 1e3
        keys = [k for k in metrics[0] if k.startswith(hook.name)] + ["sup_loss", "total_loss"]
        losses = [{k: round(float(m[k]), 6) for k in keys} for m in metrics]
        print(f"{name}: {MT_WARMUP}+{MT_TIMED} steps, losses {losses}")
        print(f"{name}: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s on {card}; "
              f"peak memory {peak:.2f} GiB above the {base / 2**30:.2f} GiB held before the run")
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"{name}: non-finite loss: {losses}")
        per_step = SEMI_STEP_LAUNCHES if name == "semi" else mt_step_launches(name)
        want = {k: n * steps for k, n in per_step.items()}
        want.update({k: 0 for k in SUPCON_KERNELS + IIC_KERNELS})
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, want {want}")
        if name == "semi":
            semi_ms.append(ms)
            del run
            continue
        by_path[name] = launches
        STEP_MS[name] = ms
        state = run.state.hook_states[hook.name]
        student = dict(run.state.model.named_parameters())
        apart = sum(int(not torch.equal(v, student[k])) for k, v in state["teacher_params"].items())
        print(f"{name}: teacher after {state['ema_step']} EMA steps, {apart}/{len(student)} "
              f"tensors apart from the student; launches {launches}")
        if state["ema_step"] != steps or apart == 0:
            raise AssertionError(f"{name}: ema_step {state['ema_step']} of {steps} steps, "
                                 f"{apart} teacher tensors apart from the student")
        check_mt_loss(run, name, errs)
        if name == "mt":
            check_mt_loss(build_semi_run(_mt_config("mt", "MeanTeacherParameters.update_bn=true"),
                                         device=device), "mt, update_bn", errs)
        del run
    semi = sum(semi_ms) / len(semi_ms)
    print(f"phase 13 steps against semi in turns ({', '.join(f'{v:.3f}' for v in semi_ms)} "
          f"ms/step, before and after) on {card}: "
          + ", ".join(f"{k} {STEP_MS[k] / semi:.2f}x" for k in MT_PASSES))
    sites = {}
    for (kernel, site), e in sorted(errs.items()):
        sites.setdefault(site, set()).add(kernel)
        print(f"  {kernel} @ {site} vs plain at {sorted(e['shapes'])}: out {e['out']:.2e} "
              f"(limit {KERNEL_RTOL:.2e}), stats {e['stats']:.2e} (limit {STATS_RTOL:.0e})")
        if e["out"] > KERNEL_RTOL or e["stats"] > STATS_RTOL:
            raise AssertionError(f"{kernel} at {site} disagrees with its plain version: {e}")
    need = {"teacher, train-mode BN", "teacher, eval-mode BN",
            "teacher, train-mode BN, statistics frozen", "ICT student, mixed views"}
    missing = [s for s in need if sites.get(s) != {"conv3x3_stats", "upconv3x3_stats"}]
    ict_batch = {shape[0] for (k, s), e in errs.items() if s == "ICT student, mixed views"
                 for shape in e["shapes"]}
    if missing or ict_batch != {10}:
        raise AssertionError(f"K1/K2 not checked at {missing} (ICT's mixed batch {ict_batch})")
    return by_path


@contextlib.contextmanager
def eval_models(seen: list):
    """Record, at each ``Trainer._inference_state`` call, the eval hook's
    name, whether the model returned is the student, and whether its
    parameters are the hook's ``eval_params`` bit for bit."""
    import torch
    from contrastyou_tpu_torch.engine.trainer import Trainer
    saved = Trainer._inference_state

    def wrapper(self):
        model = saved(self)
        hook = self._inference_hook
        want = hook.eval_params(self._state.hook_states[hook.name]) if hook else None
        seen.append((hook.name if hook else None, model is self._state.model,
                     want is not None and all(torch.equal(p, want[k])
                                              for k, p in model.named_parameters())))
        return model

    Trainer._inference_state = wrapper
    try:
        yield seen
    finally:
        Trainer._inference_state = saved


#: ``ft`` with EvalEMAParameters on phase 11's layout: one epoch of 10 steps
FT_EMA_ARGV = ["-o", "Trainer.name=ft", "+EvalEMAParameters.alpha=0.99",
               f"Trainer.num_batches={LOOP_STEPS}", "Trainer.max_epoch=1", "Trainer.save_dir=ftema"]


def run_mt_loop(device, card: str) -> dict:
    """Phase 13a: ``main.main`` with ``Trainer.name=mt`` on phase 11's
    layout: 2 epochs x 10 host-fed steps with validation and test on the
    teacher, inference on ``best``, a resume to a third epoch on the device
    cache (``mt/loop``, ``mt/loop/resume``, ``mt/loop/eval``); then ``ft``
    with EvalEMAParameters for one epoch (``ft/ema``): its EMA's
    ``ema_step`` the steps taken, eval on the EMA."""
    import gc
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint

    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    by_path: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mt_") as tmp:
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            write_loop_layout(data)
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            argv = ["-o", "Trainer.name=mt", f"Trainer.num_batches={LOOP_STEPS}",
                    "Trainer.save_dir=mt"]
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eval_counts: dict = {}
            seen: list = []
            with eval_launches(eval_counts), eval_models(seen):
                for path, extra in (("mt/loop", [f"Trainer.max_epoch={LOOP_EPOCHS}"]),
                                    ("mt/loop/resume", [f"Trainer.max_epoch={LOOP_EPOCHS + 1}",
                                                        "Trainer.device_cache=true"])):
                    _reset_counts()
                    t0 = time.perf_counter()
                    if port_main.main(argv + extra) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                    torch.cuda.synchronize()
                    by_path[path] = _counts()
                    print(f"{path}: {time.perf_counter() - t0:.1f} s; launches {by_path[path]}")
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            print(f"mt/loop: peak memory above the {base / 2**30:.2f} GiB held before the run:")
            by_path["mt/loop/eval"] = {k: eval_counts.get(k, 0) for k in by_path["mt/loop"]}
            check_loop_outputs(runs / "mt", timings.records, by_path, card, peak, path="mt/loop",
                               per_step=mt_step_launches("mt"))
            last = load_checkpoint(runs / "mt" / "last", map_location=device)["train_state"]
            teacher, model = last["hook_states"]["mt"]["teacher_params"], last["model"]
            apart = sum(int(not torch.equal(v, model[k])) for k, v in teacher.items())
            print(f"mt/loop: eval models {sorted(set(seen))} over {len(seen)} passes; teacher "
                  f"{apart}/{len(teacher)} tensors apart from the student after "
                  f"{last['hook_states']['mt']['ema_step']} EMA steps")
            if set(seen) != {("mt", False, True)} or apart == 0:
                raise AssertionError(f"mt/loop: eval models {set(seen)}, {apart} tensors apart")

            seen.clear()
            _reset_counts()
            timings.records.clear()
            t0 = time.perf_counter()
            with eval_models(seen):
                if port_main.main(FT_EMA_ARGV) != 0:
                    raise AssertionError("ft/ema: main returned non-zero")
            torch.cuda.synchronize()
            by_path["ft/ema"] = _counts()
            ema = load_checkpoint(runs / "ftema" / "last")["train_state"]["hook_states"]
            fwd = sum(r["batches"] for r in timings.records
                      if r["phase"] in ("val", "test", "inference"))
            train = [r for r in timings.records if r["phase"] == "train"]
            print(f"ft/ema: {time.perf_counter() - t0:.1f} s, hooks {sorted(ema)}, ema_step "
                  f"{ema['ema_eval']['ema_step']}; eval models {sorted(set(seen))}; "
                  f"{train[0]['seconds'] / train[0]['steps'] * 1e3:.3f} ms/step inside the loop "
                  f"on {card}; launches {by_path['ft/ema']}")
            want = {k: n * LOOP_STEPS for k, n in CHAIN_LAUNCHES["ft/loop"].items()}
            want["conv3x3_stats"] += 8 * fwd
            want["upconv3x3_stats"] += fwd
            if (sorted(ema) != ["ema_eval"] or ema["ema_eval"]["ema_step"] != LOOP_STEPS
                    or set(seen) != {("ema_eval", False, True)}
                    or any(by_path["ft/ema"][k] != n for k, n in want.items())):
                raise AssertionError(f"ft/ema: hook states {sorted(ema)}, eval models {set(seen)}, "
                                     f"launches {by_path['ft/ema']} (want {want})")
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path


#: phase 14: self-paced and superpixel InfoNCE and the resize datasets on disk.
#: One data root: an ``acdc_superpixel`` layout (ACDC at 224 x 224, 12 train
#: scans so the pretrain split holds the 6 scans of an 18-slice batch, 2
#: validation scans, 6 slices each; superpixel maps by the port's SLIC), a
#: spleen archive (native 512 x 512, 4 train and 3 validation scans) and a
#: prostate archive (native 256-384 px, 4 train and 2 validation scans of up
#: to 24 slices, 8 partitions from ``prostate_info.npy``)
SPX_SCANS, SPX_SLICES, SPX_SIZE = (12, 2), 6, 224
P14_STEPS, P14_EPOCHS = 10, 2
#: the five paths: (name, argv of ``main.main``, epochs)
P14_SP = ["+SPInfonceParams.feature_names=Conv5", "+SPInfonceParams.weights=1",
          "+SPInfonceParams.contrast_ons=partition", "+SPInfonceParams.begin_values=100",
          "+SPInfonceParams.end_values=100", "+SPInfonceParams.mode=soft"]
P14_SPX = ["+InfonceSuperPixelParams.feature_names=Up_conv2",
           "+InfonceSuperPixelParams.weights=1.0", "+InfonceSuperPixelParams.spatial_size=16",
           "Data.name=acdc_superpixel"]
P14_PATHS = [
    ("spinfonce", ["Trainer.name=pretrain", "~InfonceParams", *P14_SP], P14_EPOCHS),
    ("superpixel", ["Trainer.name=pretrain_decoder", "~InfonceParams", *P14_SPX], P14_EPOCHS),
    ("spleen/semi", ["Trainer.name=semi", "Data.name=spleen"], 1),
    ("prostate/pretrain_decoder", ["Trainer.name=pretrain_decoder", "Data.name=prostate"],
     P14_EPOCHS),
    ("semi/superpixel", ["Trainer.name=semi", *P14_SPX], P14_EPOCHS)]
#: launches per train step on each path (every eval forward adds 8 K1, 1 K2):
#: the self-paced loss is eager (no D1/D2); the superpixel hook one D1/D2
#: pair (pretraining: 18 slices x 5 points x 2 views = 180 anchors; semi: 50)
P14_LAUNCHES = {
    "spinfonce": {"conv3x3_stats": 4, "conv_dw_taps": 1, "conv3x3_bwd_fused": 3},
    "superpixel": {"conv3x3_stats": 8, "upconv3x3_stats": 1, "upconv3x3_dx": 1,
                   "conv_dw_taps": 2, "conv3x3_bwd_fused": 9, "supcon_loss": 1,
                   "supcon_dz": 1},
    "spleen/semi": SEMI_STEP_LAUNCHES,
    "prostate/pretrain_decoder": {"conv3x3_stats": 8, "upconv3x3_stats": 1,
                                  "upconv3x3_dx": 1, "conv_dw_taps": 2,
                                  "conv3x3_bwd_fused": 9, "supcon_loss": 2, "supcon_dz": 2},
    "semi/superpixel": dict(SEMI_STEP_LAUNCHES, supcon_loss=1, supcon_dz=1)}


def write_phase14_data(root) -> None:
    """Phase 14's layouts under ``root`` (see above); the superpixel maps of
    both modes from ``generate_superpixels`` (one process per CPU)."""
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like, synthesize_dataset
    from contrastyou_tpu_torch.postprocess.superpixel import generate_superpixels

    t0 = time.perf_counter()
    synthesize_acdc_like(root, num_train_scans=SPX_SCANS[0], num_val_scans=SPX_SCANS[1],
                         slices_per_scan=SPX_SLICES, size=SPX_SIZE)
    synthesize_dataset(root, "spleen", num_train_scans=4, num_val_scans=3, max_slices=10)
    synthesize_dataset(root, "prostate", num_train_scans=4, num_val_scans=2, max_slices=24)
    t1 = time.perf_counter()
    maps = sum(generate_superpixels(root / "ACDC_contrast", mode=mode)
               for mode in ("train", "val"))
    print(f"phase 14: wrote the ACDC, spleen and prostate layouts in {t1 - t0:.1f} s, "
          f"{maps} superpixel maps ({SPX_SIZE}^2, {len(os.sched_getaffinity(0))} processes) in "
          f"{time.perf_counter() - t1:.1f} s")


@contextlib.contextmanager
def checked_conv_kernels(errs: dict):
    """Route K1, K2, K3, C1 and C2 through wrappers that also run each
    kernel's plain version on the same inputs and keep, by kernel, the
    largest error relative to the plain output's largest magnitude (bf16
    outputs, limit KERNEL_RTOL; BN statistics, STATS_RTOL; weight
    gradients, DK_RTOL) and the shapes seen. The kernel launches are the
    step's own."""
    from contrastyou_tpu_torch.ops import convblock as cb
    names = (*CONV_KERNELS, *BWD_KERNELS)
    saved = {k: getattr(cb, k) for k in names}

    def record(name, shape, pairs):
        worst = errs.setdefault(name, {"err": 0.0, "rel": 0.0, "shapes": set()})
        for got, ref, limit in pairs:
            if got is None:
                continue
            err, rel = _rel_err(got, ref)
            worst["err"] = max(worst["err"], err)
            worst["rel"] = max(worst["rel"], rel / limit)
        worst["shapes"].add(shape)

    def conv(x, w, skip=None, w_skip=None, stats=True):
        got = saved["conv3x3_stats"](x, w, skip, w_skip, stats)
        ref = cb.conv3x3_stats_plain(x, w, skip, w_skip, stats)
        record("conv3x3_stats", tuple(x.shape), [(got[0], ref[0], KERNEL_RTOL),
                                                 (got[1], ref[1], STATS_RTOL),
                                                 (got[2], ref[2], STATS_RTOL)])
        return got

    def upconv(x, taps):
        got = saved["upconv3x3_stats"](x, taps)
        ref = cb.upconv3x3_stats_plain(x, taps)
        record("upconv3x3_stats", tuple(x.shape), [(got[0], ref[0], KERNEL_RTOL),
                                                   (got[1], ref[1], STATS_RTOL),
                                                   (got[2], ref[2], STATS_RTOL)])
        return got

    def upconv_dx(g, taps):
        got = saved["upconv3x3_dx"](g, taps)
        record("upconv3x3_dx", tuple(g.shape),
               [(got, cb.upconv3x3_dx_plain(g, taps), KERNEL_RTOL)])
        return got

    def dw(x, g, up2=False):
        got = saved["conv_dw_taps"](x, g, up2)
        record("conv_dw_taps", tuple(x.shape), [(got, cb.conv_dw_taps_plain(x, g, up2), DK_RTOL)])
        return got

    def bwd(x, w, g):
        got = saved["conv3x3_bwd_fused"](x, w, g)
        ref = cb.conv3x3_bwd_fused_plain(x, w, g)
        record("conv3x3_bwd_fused", tuple(x.shape), [(got[0], ref[0], KERNEL_RTOL),
                                                     (got[1], ref[1], DK_RTOL)])
        return got

    for k, f in zip(names, (conv, upconv, upconv_dx, dw, bwd)):
        setattr(cb, k, f)
    try:
        yield errs
    finally:
        for k, f in saved.items():
            setattr(cb, k, f)


def check_spleen_kernels(device, recs: dict) -> None:
    """Phase 14a: one full-width ``semi`` step at spleen's 256 x 256 crop
    (``build_semi_run``, 2 classes, 320 x 320 slices in memory) with every
    K1-K3, C1 and C2 launch held against its plain version."""
    from contrastyou_tpu_torch.main import build_semi_run, parse_config

    run = build_semi_run(parse_config(["-o", "Trainer.name=semi", "Data.name=spleen"]),
                         device=device, raw_size=320, crop=256)
    errs: dict = {}
    with checked_conv_kernels(errs):
        m = run.step(run.state, run.generator)
    if not math.isfinite(float(m["total_loss"])):
        raise AssertionError(f"spleen step: total loss {float(m['total_loss'])}")
    for name in (*CONV_KERNELS, *BWD_KERNELS):
        e = errs.get(name)
        # inputs at 256^2 or 128^2 (Up2's input); ACDC's are 224^2 and 112^2
        if e is None or not any(s[1] in (128, 256) for s in e["shapes"]):
            raise AssertionError(f"{name} not checked at spleen's shapes: {errs}")
        print(f"  {name} at spleen's shapes {sorted(e['shapes'])}: max_abs_err {e['err']:.3e} "
              f"({e['rel']:.2f} of its limit)")
        if e["rel"] > 1.0:
            raise AssertionError(f"{name} disagrees with its plain version at spleen's shapes")
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], e["err"])


def check_superpixel_supcon(device, data_root, recs: dict) -> None:
    """Phase 14b: D1 and D2 against their plain versions on the pair code
    of a superpixel batch: the first contrastive batch of the
    ``acdc_superpixel`` pretrain split (18 slices), its maps pooled to the
    16 x 16 grid, 5 positions a slice, two views -> 2N = 180 anchors whose
    positives are the positions of one superpixel id (many a row, across
    slices); z random and L2-normalized, d = 256, f32."""
    import torch
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.engine.steps import draw_points
    from contrastyou_tpu_torch.hooks.infonce import majority_pool_labels
    from contrastyou_tpu_torch.losses.contrastive import _expand_masks, pair_masks_from_target
    from contrastyou_tpu_torch.ops import supcon
    from contrastyou_tpu_torch.trainers.pretrain import get_contrastive_loader

    labeled = get_data({"name": "acdc_superpixel"}, {}, {}, root_dir=str(data_root),
                       pretrain=True)[0]
    batch = next(iter(get_contrastive_loader(labeled.dataset, data_name="acdc_superpixel")))
    maps = torch.from_numpy(batch["superpixel"]).to(device)
    g = torch.Generator(device=device).manual_seed(14)
    ys, xs = draw_points(g, maps.shape[0], (16, 16))
    pooled = majority_pool_labels(maps, 16, 16)
    labels = pooled[torch.arange(maps.shape[0], device=device)[:, None], ys, xs].reshape(-1)
    n = labels.numel()
    code = supcon.pair_code(*_expand_masks(*pair_masks_from_target(labels, n, device=device), n))
    z = torch.nn.functional.normalize(torch.randn(2 * n, 256, generator=g, device=device), dim=1)
    tau = 0.07
    got, ref = supcon.supcon_loss(z, code, tau), supcon.supcon_loss_plain(z, code, tau)
    gs = torch.ones(1, device=device)
    dz = supcon.supcon_dz(z, code, got[1], got[2], gs, tau)
    dz_ref = supcon.supcon_dz_plain(z, code, ref[1], ref[2], gs, tau)
    loss_err, loss_rel = _rel_err(got[0], ref[0])
    dz_err, dz_rel = _rel_err(dz, dz_ref)
    positives = (code == 1).sum(1).float()
    ids = len(set(labels.tolist()))
    print(f"  superpixel SupCon: {maps.shape[0]} slices, {2 * n} anchors, {ids} superpixel ids,"
          f" positives a row {int(positives.min())}-{int(positives.max())} (mean "
          f"{float(positives.mean()):.1f}); D1 max_abs_err {loss_err:.3e} (rel {loss_rel:.2e}), "
          f"D2 max_abs_err {dz_err:.3e} (rel {dz_rel:.2e})")
    if 2 * n != 180 or loss_rel > SUPCON_LOSS_RTOL or dz_rel > SUPCON_DZ_TOL:
        raise AssertionError("D1/D2 disagree with their plain versions on superpixel masks")
    recs["supcon_loss"]["max_abs_err"] = max(recs["supcon_loss"]["max_abs_err"], loss_err)
    recs["supcon_dz"]["max_abs_err"] = max(recs["supcon_dz"]["max_abs_err"], dz_err)


def check_phase14_run(path, run_dir, records: list, launches: dict, eval_counts: dict,
                      card: str) -> None:
    """Phase 14c: one path's files, finite storage values (the self-paced
    hook's ``sp_weight`` and ``age_param`` among them), launches (per step x
    steps, plus 8 K1 and 1 K2 per eval forward), and its ms/step."""
    csv_lines = (run_dir / "storage.csv").read_text().splitlines()
    header = csv_lines[0].split(",")
    rows = [{k: float(v) for k, v in zip(header, line.split(",")) if k and v}
            for line in csv_lines[1:]]
    if not (run_dir / ".success").exists() or not all(
            math.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"{path}: no .success or a non-finite value in storage.csv")
    losses = {k.split("/metrics/")[-1] if "/metrics/" in k else k: v for k, v in rows[-1].items()
              if k.endswith("loss") or "sp_weight" in k or "age_param" in k}
    if path == "spinfonce":
        sp = [v for row in rows for k, v in row.items() if k.endswith("/sp_weight")]
        age = [v for row in rows for k, v in row.items() if k.endswith("/age_param")]
        if len(sp) != len(rows) or not all(0.0 < v <= 1.0 for v in sp) or age != [100.0] * len(rows):
            raise AssertionError(f"spinfonce: sp_weight {sp}, age_param {age}")
    train = [r for r in records if r["phase"] == "train"]
    steps = sum(r["steps"] for r in train)
    fwd = sum(r["batches"] for r in records if r["phase"] in ("val", "test", "inference"))
    want = {k: n * steps for k, n in P14_LAUNCHES[path].items()}
    want["conv3x3_stats"] += 8 * fwd
    if fwd:
        want["upconv3x3_stats"] = want.get("upconv3x3_stats", 0) + fwd
    want = {k: want.get(k, 0) for k in launches}
    ms = [r["seconds"] / r["steps"] * 1e3 for r in train]
    print(f"{path}: {len(rows)} storage rows, last {losses}; train "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms/step inside the loop on {card}; "
          f"{fwd} eval forwards; launches {launches}")
    if launches != want or eval_counts.get("conv3x3_stats", 0) != 8 * fwd:
        raise AssertionError(f"{path}: launches {launches} (eval {eval_counts}), want {want}")
    STEP_MS[path] = ms[-1]


def run_phase14(device, card: str, recs: dict, extra=()) -> dict:
    """Phase 14: the layouts, the kernels at the new call sites (14a spleen's
    convs, 14b D1/D2 on superpixel masks), then each path of P14_PATHS
    through ``main.main`` with the counts set to 0 just before it and read
    just after (14c)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main

    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    by_path: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p14_") as tmp:
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            write_phase14_data(data)
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            print("phase 14a: conv kernels vs plain at spleen's 256^2 shapes:")
            check_spleen_kernels(device, recs)
            print("phase 14b: D1/D2 vs plain on superpixel masks:")
            check_superpixel_supcon(device, data, recs)
            for path, argv, epochs in P14_PATHS:
                save = path.replace("/", "_")
                eval_counts: dict = {}
                timings.records.clear()
                torch.cuda.empty_cache()
                _reset_counts()
                t0 = time.perf_counter()
                with eval_launches(eval_counts):
                    if port_main.main(["-o", *argv, f"Trainer.max_epoch={epochs}",
                                       f"Trainer.num_batches={P14_STEPS}",
                                       f"Trainer.save_dir={save}", *extra]) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                torch.cuda.synchronize()
                by_path[path] = _counts()
                print(f"{path}: {time.perf_counter() - t0:.1f} s")
                check_phase14_run(path, runs / save, timings.records, by_path[path],
                                  eval_counts, card)
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path


#: phase 15: the simple hooks, MixUp and the cross-correlation block on an
#: on-disk ACDC layout at 224 x 224 (12 train scans, so the pretrain split
#: holds the 6 scans of an 18-slice batch, 2 validation scans, 6 slices
#: each), each path through ``main.main`` for 2 epochs x 10 host-fed steps
P15_SCANS, P15_SLICES, P15_SIZE = (12, 2), 6, 224
P15_STEPS, P15_EPOCHS = 10, 2
#: config/hooks/ccblocks2.yaml and ccblocks_imsat.yaml in the override form
#: (the card's machine has no PyYAML)
P15_CC = ["+CrossCorrelationParameters.feature_name=Up_conv2",
          "+CrossCorrelationParameters.train_encoder=true",
          "+CrossCorrelationParameters.num_clusters=20",
          "+CrossCorrelationParameters.head_type=mlp",
          "+CrossCorrelationParameters.num_subheads=1", "+CrossCorrelationParameters.save=false",
          "+CrossCorrelationParameters.hooks.cc.weight=0.1",
          "+CrossCorrelationParameters.hooks.cc.kernel_size=5",
          "+CrossCorrelationParameters.hooks.cc.diff_power=0.75"]
P15_RR = ["+CrossCorrelationParameters.hooks.rr.weight=1",
          "+CrossCorrelationParameters.hooks.rr.symmetric=true",
          "+CrossCorrelationParameters.hooks.rr.lamda=1.5",
          "+CrossCorrelationParameters.hooks.rr.alpha=0.5"]
P15_IMSAT = ["+CrossCorrelationParameters.hooks.imsat.weight=0.1",
             "+CrossCorrelationParameters.hooks.imsat.use_dynamic=true"]
#: config/hooks/infonce_encoder.yaml's section over the decoder pretrain base
P15_INFONCE_ENCODER = ["InfonceParams.feature_names=Conv5", "InfonceParams.weights=1.0",
                       "InfonceParams.contrast_ons=partition", "InfonceParams.spatial_size=1"]
#: the five paths, (name, argv of ``main.main``): entmin + pseudolabel +
#: orthogonal + dae stacked under ``semi``; ``Trainer.name=mixup`` (its
#: in-code base is base.yaml + mixup.yaml); ccblocks2 under ``semi``; the
#: ``pretrain_cc`` preset (infonce_encoder + ccblocks2 under
#: ``pretrain_decoder``); the ``pretrain_clusters`` preset (ccblocks_imsat)
P15_PATHS = [
    ("semi/simple", ["Trainer.name=semi", "~ConsistencyParameters",
                     "+EntropyMinParameters.weight=0.001", "+PsuedoLabelParams.weight=0.1",
                     "+OrthogonalParameters.weight=0.001", "+DAEParameters.weight=0.1"]),
    ("mixup", ["Trainer.name=mixup"]),
    ("semi/ccblocks", ["Trainer.name=semi", "~ConsistencyParameters", *P15_CC, *P15_RR]),
    ("pretrain_cc", ["Trainer.name=pretrain_decoder", *P15_INFONCE_ENCODER, *P15_CC, *P15_RR]),
    ("pretrain_clusters", ["Trainer.name=pretrain_decoder", "~InfonceParams", *P15_CC,
                           *P15_IMSAT])]
#: launches per train step (every eval forward adds 8 K1, 1 K2): MixUp's
#: labeled and mixed forwards (batches 5 and 10) and their backward, as
#: ``semi``'s two passes; the pretrain paths cut at Up_conv2, with one D1/D2
#: pair for the Conv5 InfoNCE hook of ``pretrain_cc`` (36 anchors)
P15_DECODER = {"conv3x3_stats": 8, "upconv3x3_stats": 1, "upconv3x3_dx": 1, "conv_dw_taps": 2,
               "conv3x3_bwd_fused": 9}
P15_LAUNCHES = {"semi/simple": SEMI_STEP_LAUNCHES, "mixup": SEMI_STEP_LAUNCHES,
                "semi/ccblocks": SEMI_STEP_LAUNCHES,
                "pretrain_cc": dict(P15_DECODER, supcon_loss=1, supcon_dz=1),
                "pretrain_clusters": P15_DECODER}


def check_mixup_kernels(device, recs: dict) -> None:
    """Phase 15a: the MixUp hook's extra forward at full width (5 labeled
    slices and their second view, mixed: batch 10, running statistics left
    alone) and its backward, every K1, K2, K3, C1 and C2 launch held against
    its plain version; then one ``ft`` step with the hook and one without,
    from the same weights, batch and draws: the same BN running statistics,
    bit for bit."""
    import numpy as np
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.engine.steps import build_train_step, sample_ft_draws
    from contrastyou_tpu_torch.main import MIXUP_CONFIG, build_semi_run

    def fresh():
        run = build_semi_run(MIXUP_CONFIG, device=device, n_slices=10)
        return run, ModelBundle(run.state.model, (P15_SIZE, P15_SIZE, 1))

    run, bundle = fresh()
    g = torch.Generator(device=device).manual_seed(15)
    lab = run.labeled_cache.sample(g, 5)
    hook = run.hooks[0]
    draws = sample_ft_draws(g, [hook], host_rng=np.random.default_rng(15),
                            shape=tuple(lab["image"].shape))
    model = run.state.model.train()
    stats = {k: v.clone() for k, v in model.named_buffers()}
    ctx = StepContext(labeled_image=lab["image"], labeled_target=lab["target"],
                      labeled_logits=torch.zeros(1, 1, 1, model.num_classes, device=device),
                      bundle=bundle, hook_draws=draws.hooks)
    errs: dict = {}
    with checked_conv_kernels(errs):
        loss = hook.loss(ctx, {})[0]
        loss.backward()
    torch.cuda.synchronize()
    if not math.isfinite(loss.item()):
        raise AssertionError(f"mixup loss {loss.item()}")
    if any(not torch.equal(v, stats[k]) for k, v in model.named_buffers()):
        raise AssertionError("the mixed forward moved the BN running statistics")
    for name in (*CONV_KERNELS, *BWD_KERNELS):
        e = errs.get(name)
        if e is None or any(s[0] != 10 for s in e["shapes"]):
            raise AssertionError(f"{name} not checked at MixUp's batch 10: {errs}")
        print(f"  {name} at MixUp's batch-10 shapes ({len(e['shapes'])}): max_abs_err "
              f"{e['err']:.3e} ({e['rel']:.2f} of its limit)")
        if e["rel"] > 1.0:
            raise AssertionError(f"{name} disagrees with its plain version at MixUp's shapes")
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], e["err"])
    batch = {"labeled_image": lab["image"], "labeled_target": lab["target"]}
    after = []
    for hooks in ([hook], []):
        r, b = fresh()
        build_train_step(b, hooks, mode="ft")(r.state, batch, draws)
        after.append(dict(r.state.model.named_buffers()))
    same = all(torch.equal(v, after[1][k]) for k, v in after[0].items())
    print(f"  BN running statistics after an ft step with MixUp equal those without: {same}")
    if not same:
        raise AssertionError("MixUp's forward changed the step's BN running statistics")


def check_orth_reaches_the_weight(device, **sizes) -> None:
    """Phase 15a: one ``semi/simple`` step with the orthogonal hook and one
    without it, from the same weights, batch and draws: the two steps'
    ``Deconv_1x1`` gradients differ by the hook's weight times the gradient
    of the prototypes' (Gram - I)^2 at the starting weight, computed plainly
    in f32, to 1e-2 in L2. ``sizes``: :func:`build_semi_run`'s size
    arguments."""
    import torch
    from contrastyou_tpu_torch.main import build_semi_run, parse_config

    orth_arg = "+OrthogonalParameters.weight=0.001"
    argv = dict(P15_PATHS)["semi/simple"]
    runs = [build_semi_run(parse_config(["-o", *(a for a in argv if keep or a != orth_arg)]),
                           device=device, n_slices=10, **sizes) for keep in (True, False)]
    orth = [h for h in runs[0].hooks if h.name == "orth"]
    if len(orth) != 1 or any(h.name == "orth" for h in runs[1].hooks):
        raise AssertionError(f"hooks {[h.name for h in runs[0].hooks]}, "
                             f"{[h.name for h in runs[1].hooks]}")
    starts = [run.state.model._Deconv_1x1.weight.detach().clone() for run in runs]
    w0 = starts[0]
    metrics, grads = [], []
    for run in runs:
        metrics.append(run.step(run.state, run.generator, 0, run.host_rng))
        grads.append(run.state.model._Deconv_1x1.weight.grad.detach().float())
    same = (torch.equal(starts[0], starts[1])
            and torch.equal(metrics[0]["sup_loss"], metrics[1]["sup_loss"]))
    w = w0.reshape(w0.shape[0], -1).float().requires_grad_()
    protos = w / w.norm(dim=1, keepdim=True).clamp(min=1e-12)
    eye = torch.eye(w.shape[0], device=w.device)
    ((protos @ protos.T - eye) ** 2).mean().backward()
    want = orth[0].weight * w.grad.reshape(w0.shape)
    err = float((grads[0] - grads[1] - want).norm() / want.norm())
    print(f"  orth: the Deconv_1x1 gradient with the hook less the one without it vs "
          f"{orth[0].weight} x the plain d(orth)/dW: L2 {err:.3e}; same sup loss {same}")
    if not same or not err <= 1e-2:
        raise AssertionError(f"the orthogonal hook's gradient did not reach Deconv_1x1: "
                             f"L2 {err}, same sup loss {same}")


def check_pretrain_cc_supcon(device) -> None:
    """Phase 15b: ``pretrain_cc``'s InfoNCE hook (Conv5, 36 anchors) on one
    batch through D1 against the plain SupCon (``check_hook_losses``, the
    cross-correlation hook beside it left out)."""
    from contrastyou_tpu_torch.main import build_pretrain_run, parse_config

    argv = dict(P15_PATHS)["pretrain_cc"]
    run = build_pretrain_run(parse_config(["-o", *argv]), device=device)
    check_hook_losses(run)


@contextlib.contextmanager
def start_snapshot(seen: dict):
    """Record each trainer's model and hook-module parameters right before
    its first epoch, by ``save_dir``."""
    from contrastyou_tpu_torch.engine.trainer import Trainer
    from contrastyou_tpu_torch.trainers.pretrain import PretrainEncoderTrainer
    saved = Trainer.start_training, PretrainEncoderTrainer.start_training

    def wrap(fn):
        def start(self):
            seen[self.save_dir] = {
                "model": {k: p.detach().clone() for k, p in self._model.named_parameters()},
                "hooks": {h.name: {k: v.clone() for k, v in h.state_dict().items()}
                          for h in self._active_hooks if hasattr(h, "state_dict")}}
            return fn(self)
        return start

    Trainer.start_training = wrap(saved[0])
    PretrainEncoderTrainer.start_training = wrap(saved[1])
    try:
        yield seen
    finally:
        Trainer.start_training, PretrainEncoderTrainer.start_training = saved


def check_phase15_run(path, run_dir, records: list, launches: dict, eval_counts: dict,
                      start: dict, card: str) -> None:
    """Phase 15c: one path's files (``inference_result.json`` but for
    pretraining), finite ``storage.csv`` values, the launches (per step x
    steps, plus 8 K1 and 1 K2 per eval forward), what the path must move
    (``semi/simple``: the DAE conv and Deconv_1x1; ``pretrain_clusters``:
    the logged imsat weight between epochs), and its ms/step."""
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint

    pretrain = path.startswith("pretrain")
    csv_lines = (run_dir / "storage.csv").read_text().splitlines()
    header = csv_lines[0].split(",")
    rows = [{k: float(v) for k, v in zip(header, line.split(",")) if k and v}
            for line in csv_lines[1:]]
    files = [".success", "last/train_state.pt"] + ([] if pretrain else ["inference_result.json"])
    missing = [f for f in files if not (run_dir / f).exists()]
    if missing or len(rows) != P15_EPOCHS or not all(
            math.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"{path}: missing {missing}, {len(rows)} rows, or a non-finite "
                             f"value in storage.csv")
    losses = {k.split("/metrics/")[-1] if "/metrics/" in k else k: v for k, v in rows[-1].items()
              if k.startswith("tra/") and (k.endswith("loss") or "/metrics/" in k)}
    saved = load_checkpoint(run_dir / "last", map_location="cpu")["train_state"]
    if path == "semi/simple":
        moved = {k: not torch_equal(saved["hooks"]["dae"][k], start["hooks"]["dae"][k])
                 for k in start["hooks"]["dae"]}
        moved["_Deconv_1x1.weight"] = not torch_equal(saved["model"]["_Deconv_1x1.weight"],
                                                      start["model"]["_Deconv_1x1.weight"])
        print(f"{path}: moved {moved}")
        if not all(moved.values()):
            raise AssertionError(f"{path}: the DAE conv or Deconv_1x1 did not move: {moved}")
    if path == "pretrain_clusters":
        weights = [row["tra/cc_Up_conv2/metrics/imsat_weight"] for row in rows]
        state = float(saved["hook_states"]["cc_Up_conv2"]["imsat_weight"])
        print(f"{path}: imsat weight by epoch {weights}, in the checkpoint {state}")
        if len(set(weights)) != len(weights) or state in weights:
            raise AssertionError(f"{path}: the imsat weight did not move: {weights}, {state}")
    train = [r for r in records if r["phase"] == "train"]
    steps = sum(r["steps"] for r in train)
    fwd = sum(r["batches"] for r in records if r["phase"] in ("val", "test", "inference"))
    want = {k: n * steps for k, n in P15_LAUNCHES[path].items()}
    want["conv3x3_stats"] += 8 * fwd
    want["upconv3x3_stats"] += fwd
    want = {k: want.get(k, 0) for k in launches}
    ms = [r["seconds"] / r["steps"] * 1e3 for r in train]
    print(f"{path}: {len(rows)} storage rows, last {losses}; train "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms/step inside the loop on {card}; "
          f"{fwd} eval forwards; launches {launches}")
    if launches != want or eval_counts.get("conv3x3_stats", 0) != 8 * fwd:
        raise AssertionError(f"{path}: launches {launches} (eval {eval_counts}), want {want}")
    STEP_MS[path] = ms[-1]


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a.cpu(), b.cpu())


def run_phase15(device, card: str, recs: dict, extra=()) -> dict:
    """Phase 15: the layout, the kernels at the new call sites (15a MixUp's
    batch-10 forward and backward, 15b D1 on ``pretrain_cc``'s anchors),
    then each path of P15_PATHS through ``main.main`` with the counts set to
    0 just before it and read just after (15c)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like

    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    by_path: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p15_") as tmp:
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            t0 = time.perf_counter()
            synthesize_acdc_like(data, num_train_scans=P15_SCANS[0], num_val_scans=P15_SCANS[1],
                                 slices_per_scan=P15_SLICES, size=P15_SIZE)
            print(f"phase 15: wrote the ACDC layout in {time.perf_counter() - t0:.1f} s")
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            print("phase 15a: MixUp's extra forward and backward vs plain (batch 10):")
            check_mixup_kernels(device, recs)
            check_orth_reaches_the_weight(device)
            torch.cuda.empty_cache()
            print("phase 15b: pretrain_cc's InfoNCE hook through D1 vs the plain SupCon:")
            check_pretrain_cc_supcon(device)
            torch.cuda.empty_cache()
            for path, argv in P15_PATHS:
                save = path.replace("/", "_")
                eval_counts: dict = {}
                starts: dict = {}
                timings.records.clear()
                torch.cuda.empty_cache()
                _reset_counts()
                t0 = time.perf_counter()
                with eval_launches(eval_counts), start_snapshot(starts):
                    if port_main.main(["-o", *argv, f"Trainer.max_epoch={P15_EPOCHS}",
                                       f"Trainer.num_batches={P15_STEPS}",
                                       f"Trainer.save_dir={save}", *extra]) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                torch.cuda.synchronize()
                by_path[path] = _counts()
                print(f"{path}: {time.perf_counter() - t0:.1f} s")
                check_phase15_run(path, runs / save, timings.records, by_path[path],
                                  eval_counts, starts[str(runs / save)], card)
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path

#: phase 16a, the whole product: bf16 moves a whole-network second
#: derivative far from f32 on both paths (the first derivative already
#: moves 40-90%), so besides the limit on its distance to the plain bf16
#: product (``HV_PLAIN_RTOL``), the kernel path's H v is at most
#: ``HV_FACTOR`` times as far from the f32 H v as the plain bf16 path's,
#: plus ``HV_ATOL``, over the whole product and at each kernel-backed level;
#: and no such level's H v may be zero (the silent loss of the
#: second-order term a backward without a graph causes)
HV_FACTOR, HV_ATOL = STAGE_FACTOR, STAGE_ATOL
#: relative L2 of the kernel path's H v from the plain bf16 path's, over the
#: whole product and at each level: two bf16 roundings of every
#: intermediate, magnified by the BN backward's cancellations, lay
#: 0.119-0.264 apart on the H100 at these inputs (0.203 over all; a copy of
#: the inner loss on other inputs gave 0.139-0.263), so the limit is 1.5x
#: the largest reading; the Functions' own checks hold each derivative to
#: its kernel's tolerance
HV_PLAIN_RTOL = 0.4
#: a weight gradient of the double backward: C1's f32 sums (DK_RTOL)
#: rounded to the weights' bf16, where a rounding may flip one ulp (<= 2^-7
#: of the value)
DK_BF16_RTOL = DK_RTOL + 2.0 ** -7
#: the levels whose convs run on the kernels at full width
HV_LEVELS = ("_Conv1.", "_Conv2.", "_Up2.", "_Up_conv3.", "_Up_conv2.")
DMT_METHOD = "DifferentiableMeanTeacherParameters.method_name"
#: (forwards, backward passes) of a DMT step: the student's two; the
#: teacher's consistency forward; a meta gradient (forward and backward)
#: in ``method1``-``method4``; ``method4``'s teacher forward at t
DMT_PASSES = {"mt": (3, 2), "method1": (4, 3), "method2": (4, 3), "method3": (4, 3),
              "method4": (5, 3)}
#: launches of the backward of one pass's create-graph backward: each of
#: its 9 C2 Functions K1 3 (its x, w-transposed and g sides) and C1 1;
#: Conv1.conv0's C1 Function K1 1 (the image takes no gradient); Up2's C1
#: Function K3 1 and K2 1, its K3 Function K2 1 and C1 1; plus the pass's
#: own first-order backward again (its outputs feed the cotangents)
DOUBLE_BWD_PASS = {"conv3x3_stats": 28, "upconv3x3_stats": 2, "upconv3x3_dx": 2,
                   "conv_dw_taps": 12, "conv3x3_bwd_fused": 9}
P16_STEPS, P16_EPOCHS = 10, 2
#: the five paths of phase 16c, (name, argv of ``main.main``): the dmt
#: preset (``method1``), its ``second_order``, the multicore preset (8
#: prototypes a class: 32 channels) with the METHODS grid's IIC hook, the
#: same with the mean teacher of config/hooks/mt.yaml (``multicore_mt``),
#: the adv preset (``reg_weight`` 0.01)
P16_MT = ["+MeanTeacherParameters.weight=1", "+MeanTeacherParameters.alpha=0.99",
          "+MeanTeacherParameters.weight_decay=0.000001",
          "+MeanTeacherParameters.update_bn=false", "+MeanTeacherParameters.hard_clip=false"]
P16_PATHS = [("dmt", ["Trainer.name=dmt"]),
             ("dmt/second_order", ["Trainer.name=dmt", f"{DMT_METHOD}=second_order"]),
             ("multicore", ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01"]),
             ("multicore_mt", ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01",
                               *P16_MT]),
             ("adv", ["Trainer.name=adv"])]


def passes_launches(forwards: int, backwards: int, double: int = 0) -> dict:
    """K1 8 and K2 1 a forward; K3 1, C1 2 and C2 9 a backward pass;
    ``DOUBLE_BWD_PASS`` per pass differentiated twice."""
    single = {"conv3x3_stats": 8 * forwards, "upconv3x3_stats": forwards,
              "upconv3x3_dx": backwards, "conv_dw_taps": 2 * backwards,
              "conv3x3_bwd_fused": 9 * backwards}
    return {k: v + double * DOUBLE_BWD_PASS[k] for k, v in single.items()}


#: a ``second_order`` step: 7 forwards (the student's two, the teacher's
#: two, the inner loss's two, the meta loss at t1), 5 backward passes (the
#: student's two, the inner loss's two with create_graph, the meta loss's),
#: and the inner loss's two passes differentiated again (checked with the
#: plain versions counted at full width on the CPU: 112, 11, 9, 34, 63)
SECOND_ORDER_LAUNCHES = passes_launches(7, 5, 2)
#: 16a's H v through ``virtual_teacher``: the teacher's forward, the inner
#: loss's 2 forwards, their create-graph backward, and both differentiated
#: again
HV_LAUNCHES = passes_launches(3, 2, 2)
P16_LAUNCHES = {"dmt": passes_launches(*DMT_PASSES["method1"]),
                "dmt/second_order": SECOND_ORDER_LAUNCHES,
                "multicore": passes_launches(2, 2), "multicore_mt": passes_launches(3, 2),
                "adv": passes_launches(2, 2)}


def check_double_backward_functions(device) -> None:
    """Phase 16a, first part: the backward of each Function the double
    backward runs (ops/convblock.py), through the kernels and under
    ``plain_kernels()``, on identical bf16 inputs and cotangents at the
    full-width U-Net's batch-5 shapes, with the launches of the kernel run.
    One kernel's bf16 output is held to KERNEL_RTOL; a weight gradient to
    DK_BF16_RTOL; C2's g side, conv(g_dx, w) + conv(x, g_dk), the sum of two
    K1 outputs, to KERNEL_RTOL of the two terms' largest magnitudes summed
    (each term may flip an ulp, and the sum's rounding one more)."""
    import torch
    from contrastyou_tpu_torch.ops import convblock as cb

    gen = torch.Generator(device=device).manual_seed(161)
    B, f32 = 5, torch.float32

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    def conv_dw(up2):
        return lambda x, g: cb._ConvDw.apply(x, g, up2)

    # (label, Function, inputs, which take a gradient, the outputs'
    # cotangents, the gradients' names, the launches of the backward)
    cases = [("_Conv3x3 32->32 @224", cb._Conv3x3.apply,
              (randn(B, 224, 224, 32), randn(3, 3, 32, 32)), (True, True),
              (randn(B, 224, 224, 32),), ("dx", "dw"), {"conv3x3_bwd_fused": 1}),
             ("_ConvDw Conv1.conv0", conv_dw(False),
              (randn(B, 224, 224, 1), randn(B, 224, 224, 32)), (False, True),
              (randn(9, 1, 32, dtype=f32),), ("dg",), {"conv3x3_stats": 1}),
             ("_ConvDw Up2", conv_dw(True),
              (randn(B, 112, 112, 64), randn(B, 224, 224, 32)), (True, True),
              (randn(16, 64, 32, dtype=f32),), ("dx", "dg"),
              {"upconv3x3_dx": 1, "upconv3x3_stats": 1}),
             *((f"_Conv3x3Bwd {ci}->{co} @{H}", cb._Conv3x3Bwd.apply,
                (randn(B, H, H, ci), randn(3, 3, ci, co), randn(B, H, H, co)), (True,) * 3,
                (randn(B, H, H, ci), randn(3, 3, ci, co, dtype=f32)), ("dx", "dw", "dg"),
                {"conv3x3_stats": 3, "conv_dw_taps": 1})
               for ci, co, H in ((32, 32, 224), (32, 64, 112), (64, 64, 112))),
             ("_UpconvDx Up2", cb._UpconvDx.apply,
              (randn(B, 224, 224, 32), randn(4, 4, 64, 32)), (True, True),
              (randn(B, 112, 112, 64),), ("dg", "dtaps"),
              {"upconv3x3_stats": 1, "conv_dw_taps": 1})]

    def backward(fn, inputs, needs, cots):
        leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        torch.cuda.synchronize()
        _reset_counts()
        grads = torch.autograd.grad(outs if isinstance(outs, tuple) else (outs,),
                                    [t for t in leaves if t.requires_grad], cots)
        torch.cuda.synchronize()
        return grads, {k: n for k, n in _counts().items() if n}

    for label, fn, inputs, needs, cots, names, want in cases:
        got, launches = backward(fn, inputs, needs, cots)
        with plain_kernels():
            ref, _ = backward(fn, inputs, needs, cots)
        errs = []
        for name, a, b in zip(names, got, ref):
            err = (a.float() - b.float()).abs().max().item()
            if name == "dg" and label.startswith("_Conv3x3Bwd"):
                x, w, _ = inputs
                terms = (cb.conv3x3_stats_plain(cots[0], w, stats=False)[0],
                         cb.conv3x3_stats_plain(x, cots[1].to(x.dtype), stats=False)[0])
                scale = sum(t.float().abs().max().item() for t in terms)
                limit = KERNEL_RTOL
            else:
                scale = b.float().abs().max().item()
                limit = DK_BF16_RTOL if name in ("dw", "dtaps") else KERNEL_RTOL
            rel = err / max(scale, 1e-30)
            errs.append(f"{name} {rel:.2e} (limit {limit:.2e})")
            if not (rel <= limit and a.shape == b.shape and scale > 0):
                raise AssertionError(f"{label}: {name} {rel:.3e} from the plain backward "
                                     f"(limit {limit:.3e}), shape {tuple(a.shape)}")
        print(f"  {label} backward vs plain: {', '.join(errs)}; launches {launches}")
        if launches != want:
            raise AssertionError(f"{label}: the backward launched {launches}, want {want}")


def check_double_backward(device, card: str, size: int = 224) -> dict:
    """Phase 16a (see ``HV_PLAIN_RTOL`` and ``HV_FACTOR``): the Functions'
    checks, then H v of the inner loss through the DMT hook's
    ``virtual_teacher`` -> the launches of the kernel run. With alpha 0 and
    meta_weight 1 the hook's t1 is p - grad(inner), so the gradient of
    <t1, v> in the student's parameters is v - H v."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.hooks.dmt import DifferentiableMeanTeacherTrainerHook
    from contrastyou_tpu_torch.main import synthetic_split
    from contrastyou_tpu_torch.models.unet import UNet
    from contrastyou_tpu_torch.ops.affine import sample_gammas, sample_geo_params, transform_image

    print("phase 16a: the double backward's Functions at full width, batch 5:")
    check_double_backward_functions(device)
    gen = torch.Generator(device=device).manual_seed(16)
    weights = UNet(max_channel=512, momentum=0.01).to(device).init_weights(gen).state_dict()
    images, targets = synthetic_split(10, size, seed=16)
    lab = torch.from_numpy(images[:5, ..., None]).to(device)
    target = torch.from_numpy(targets[:5]).to(device)
    unl = torch.from_numpy(images[5:, ..., None]).to(device)
    geo = sample_geo_params(gen, 5)
    unl_tf = transform_image(unl, geo, sample_gammas(gen, 5))
    hook = DifferentiableMeanTeacherTrainerHook(name="dmt", alpha=0.0, meta_weight=1.0,
                                                method_name="second_order")
    names = [k for k, _ in UNet(max_channel=512).named_parameters()]
    vs = {k: torch.randn(weights[k].shape, generator=gen, device=device) for k in names}

    def hv(dtype, stages=None):
        model = UNet(max_channel=512, momentum=0.01, dtype=dtype).to(device)
        model.load_state_dict(weights)
        bundle = ModelBundle(model, (size, size, 1))
        state = hook.init_state(bundle)
        # labeled_logits: the hook reads only its class count
        ctx = StepContext(labeled_image=lab, labeled_target=target,
                          labeled_logits=lab.new_zeros(5, size, size, model.num_classes),
                          unlabeled_image=unl, unlabeled_image_tf=unl_tf, geo_params=geo,
                          bundle=bundle)
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t1 = hook.virtual_teacher(ctx, state)
        marks = [_counts()]
        dot = sum((t1[k].float() * vs[k]).sum() for k in names)
        out = torch.autograd.grad(dot, [params[k] for k in names])
        torch.cuda.synchronize()
        marks.append(_counts())
        if stages is not None:
            stages["ms"] = (time.perf_counter() - t0) * 1e3
            prev = {k: 0 for k in marks[0]}
            for label, m in zip(("virtual_teacher (teacher forward, inner loss forwards, "
                                 "create-graph backward)", "backward of the backward"), marks):
                stages[label] = {k: m[k] - prev[k] for k in m if m[k] - prev[k]}
                prev = m
        return {k: (vs[k] - g.float()).detach() for k, g in zip(names, out)}

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stages: dict = {}
    _reset_counts()
    got = hv(torch.bfloat16, stages)
    launches = _counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with plain_kernels():
        plain = hv(torch.bfloat16)
        ref = hv(torch.float32)

    def rel(a, b, keys):
        num = math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys))
        return num / max(math.sqrt(sum(float((b[k] ** 2).sum()) for k in keys)), 1e-30)

    print(f"phase 16a: H v of the inner loss through virtual_teacher and the kernels in "
          f"{stages['ms']:.1f} ms, peak {peak:.2f} GiB above the process's, on {card}")
    for label in [k for k in stages if k != "ms"]:
        print(f"  launches, {label}: {stages[label]}")
    for level, keys in (("all", names), *((lv.strip("_."), [k for k in names if k.startswith(lv)])
                                          for lv in HV_LEVELS)):
        ek, ep, ekp = rel(got, ref, keys), rel(plain, ref, keys), rel(got, plain, keys)
        norm = math.sqrt(sum(float((got[k] ** 2).sum()) for k in keys))
        print(f"  H v {level}: kernels vs plain {ekp:.3e} (limit {HV_PLAIN_RTOL}); kernels vs "
              f"f32 {ek:.3e}, plain bf16 vs f32 {ep:.3e}; |H v| {norm:.3e}")
        if (not (math.isfinite(norm) and norm > 0) or ekp > HV_PLAIN_RTOL
                or ek > HV_FACTOR * ep + HV_ATOL):
            raise AssertionError(f"H v at {level}: |H v| {norm}, kernels {ekp:.3e} from plain, "
                                 f"{ek:.3e} from f32, plain bf16 {ep:.3e} from f32")
    if {k: launches[k] for k in HV_LAUNCHES} != HV_LAUNCHES:
        raise AssertionError(f"the double backward launched {launches}, want {HV_LAUNCHES}")
    return launches


def run_dmt_steps(device, card: str, **sizes) -> dict:
    """Phase 16b: per update rule, one warm-up and one timed step of
    ``build_semi_run`` at full width (the counts over both); ``sizes`` go to
    ``build_semi_run``."""
    import gc

    import torch
    from contrastyou_tpu_torch.main import build_semi_run, parse_config

    by_path = {}
    for method in ("mt", "method2", "method3", "method4"):
        run = build_semi_run(parse_config(["-o", "Trainer.name=dmt", f"{DMT_METHOD}={method}"]),
                             device=device, **sizes)
        start = {k: v.clone() for k, v in run.state.hook_states["dmt"]["teacher_params"].items()}
        torch.cuda.synchronize()
        _reset_counts()
        warm = run.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = run.run(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = by_path[f"dmt/{method}"] = _counts()
        want = {k: 2 * n for k, n in passes_launches(*DMT_PASSES[method]).items()}
        losses = [float(m[k]) for m in warm + timed for k in ("total_loss", "dmt/loss")]
        teacher = run.state.hook_states["dmt"]["teacher_params"]
        moved = sum(not torch.equal(teacher[k], v) for k, v in start.items())
        print(f"  dmt/{method}: losses {losses}; {ms:.1f} ms for the timed step on {card}; "
              f"{moved} of {len(start)} teacher tensors moved; launches {counts}")
        if (not all(math.isfinite(v) for v in losses) or not moved
                or {k: counts[k] for k in want} != want):
            raise AssertionError(f"dmt/{method}: losses {losses}, {moved} teacher tensors moved, "
                                 f"launches {counts}, want {want}")
        STEP_MS[f"dmt/{method}"] = ms
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def check_phase16_run(path, run_dir, records: list, launches: dict, eval_counts: dict,
                      start: dict, card: str, peak: float) -> None:
    """Phase 16c: one path's files, finite ``storage.csv`` values, the
    launches (per step x steps, plus 8 K1 and 1 K2 per eval forward), the
    teacher moved (dmt) or the checkpoint holding the initial segmenter
    (adv, as JAX's), and its ms/step."""
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint

    csv_lines = (run_dir / "storage.csv").read_text().splitlines()
    header = csv_lines[0].split(",")
    rows = [{k: float(v) for k, v in zip(header, line.split(",")) if k and v}
            for line in csv_lines[1:]]
    files = [".success", "last/train_state.pt", "config.yaml"]
    files += [] if path == "adv" else ["inference_result.json"]
    missing = [f for f in files if not (run_dir / f).exists()]
    if (missing or len(rows) != P16_EPOCHS or (path == "adv") != (
            not (run_dir / "inference_result.json").exists())
            or not all(math.isfinite(v) for row in rows for v in row.values())):
        raise AssertionError(f"{path}: missing {missing}, {len(rows)} rows, an "
                             f"inference_result.json where JAX writes none, or a non-finite "
                             f"value in storage.csv")
    saved = load_checkpoint(run_dir / "last", map_location="cpu")["train_state"]
    if path.startswith("dmt"):
        teacher = saved["hook_states"]["dmt"]["teacher_params"]
        moved = sum(not torch_equal(teacher[k], v) for k, v in start["model"].items())
        print(f"{path}: {moved} of {len(teacher)} teacher tensors moved from the initial weights")
        if not moved:
            raise AssertionError(f"{path}: the teacher did not move")
    if path == "adv":
        same = all(torch_equal(saved["model"][k], v) for k, v in start["model"].items())
        print(f"{path}: the checkpoint holds the initial segmenter, as JAX's: {same}")
        if not same:
            raise AssertionError(f"{path}: the checkpoint does not hold what JAX's holds")
    train = [r for r in records if r["phase"] == "train"]
    steps = sum(r["steps"] for r in train)
    fwd = sum(r["batches"] for r in records if r["phase"] in ("val", "test", "inference"))
    want = {k: n * steps for k, n in P16_LAUNCHES[path].items()}
    want["conv3x3_stats"] += 8 * fwd
    want["upconv3x3_stats"] += fwd
    want = {k: want.get(k, 0) for k in launches}
    ms = [r["seconds"] / r["steps"] * 1e3 for r in train]
    last = {k.split("/metrics/")[-1] if "/metrics/" in k else k: v for k, v in rows[-1].items()
            if k.startswith("tra/") and ("loss" in k or "/metrics/" in k)}
    print(f"{path}: {len(rows)} storage rows, last {last}; train "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms/step inside the loop on {card}; peak "
          f"{peak:.2f} GiB above the process's; {fwd} eval forwards; launches {launches}")
    if launches != want or eval_counts.get("conv3x3_stats", 0) != 8 * fwd:
        raise AssertionError(f"{path}: launches {launches} (eval {eval_counts}), want {want}")
    STEP_MS[path] = ms[-1]


def run_phase16(device, card: str, extra=()) -> dict:
    """Phase 16: 16a, 16b, then each path of P16_PATHS through ``main.main``
    on phase 15's layout with the counts set to 0 just before it and read
    just after (16c)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like

    by_path = {"dmt/double_backward": check_double_backward(device, card)}
    torch.cuda.empty_cache()
    print("phase 16b: one full-width step of each first-order DMT rule:")
    by_path.update(run_dmt_steps(device, card))
    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as tmp:
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            synthesize_acdc_like(data, num_train_scans=P15_SCANS[0], num_val_scans=P15_SCANS[1],
                                 slices_per_scan=P15_SLICES, size=P15_SIZE)
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            for path, argv in P16_PATHS:
                save = path.replace("/", "_")
                eval_counts: dict = {}
                starts: dict = {}
                timings.records.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                _reset_counts()
                t0 = time.perf_counter()
                with eval_launches(eval_counts), start_snapshot(starts):
                    if port_main.main(["-o", *argv, f"Trainer.max_epoch={P16_EPOCHS}",
                                       f"Trainer.num_batches={P16_STEPS}",
                                       f"Trainer.save_dir={save}", *extra]) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                torch.cuda.synchronize()
                by_path[path] = _counts()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                print(f"{path}: {time.perf_counter() - t0:.1f} s")
                check_phase16_run(path, runs / save, timings.records, by_path[path],
                                  eval_counts, starts[str(runs / save)], card, peak)
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path



P17_STEPS, P17_EPOCHS = 10, 2
#: the five paths of phase 17d, (name, argv of ``main.main``)
P17_PATHS = [("resunet/semi", ["Trainer.name=semi", "Arch.name=resunet"]),
             ("resunet/pretrain_decoder", ["Trainer.name=pretrain_decoder", "Arch.name=resunet"]),
             ("groupnorm/semi", ["Trainer.name=semi", "+Arch.norm=groupnorm"]),
             ("semi/accumulate", ["Trainer.name=semi", "Trainer.accumulate_iter=2"]),
             ("semi/one_stage", ["Trainer.name=semi", "Trainer.two_stage=false"])]


def resunet_launches(forwards: int, backwards: int) -> dict:
    """The ResUNet's kernel levels (its encoder runs on cuDNN): a forward's
    K1 the two convs of Up_conv3 and of Up_conv2 (each first one with its
    skip) and K2 Up2; a backward pass's C2 each of those convs' inputs (x
    and skip: 6), K3 Up2's dx and C1 its parity taps."""
    return {"conv3x3_stats": 4 * forwards, "upconv3x3_stats": forwards,
            "upconv3x3_dx": backwards, "conv_dw_taps": backwards,
            "conv3x3_bwd_fused": 6 * backwards}


#: launches per train step (predicted from the code before the first run):
#: ``semi`` two passes, ``pretrain_decoder`` one (cut at Up_conv2, the two
#: InfoNCE hooks one D1/D2 pair each), ``two_stage=false`` one pass of batch
#: 15; the GroupNorm net and MultiSteps launch as the BN net does on every
#: call
P17_LAUNCHES = {"resunet/semi": resunet_launches(2, 2),
                "resunet/pretrain_decoder": dict(resunet_launches(1, 1), supcon_loss=2,
                                                 supcon_dz=2),
                "groupnorm/semi": passes_launches(2, 2),
                "semi/accumulate": passes_launches(2, 2),
                "semi/one_stage": passes_launches(1, 1)}
#: (K1, K2) launches of one eval forward: the U-Net's 8 and 1, the ResUNet's 4 and 1
P17_EVAL = {"resunet/semi": (4, 1)}
#: phase 17a: the semi steps whose every K1-K3, C1 and C2 launch is checked
#: against its plain version, with the batch K1 must see there
P17_CHECKED = [("groupnorm", ["+Arch.norm=groupnorm"], 10),
               ("one_stage", ["Trainer.two_stage=false"], 15),
               ("resunet", ["Arch.name=resunet"], 10)]
#: phase 17b: one timed step of each optimizer under each schedule
P17_OPTIMS = [(o, sch) for o in ("adam", "adamw", "sgd") for sch in ("poly", "step")]


def check_phase17_kernels(device, recs: dict) -> None:
    """Phase 17a: the GroupNorm U-Net's kernel levels (per-sample group
    statistics from K1/K2's sums, their per-sample cotangent folded into
    C1/C2's) against f32 as the plain bf16 path is, at batches 5 and 15;
    then one full-width ``semi`` step of each of ``P17_CHECKED`` with every
    K1-K3, C1 and C2 launch held against its plain version."""
    import gc

    import torch
    from contrastyou_tpu_torch.main import build_semi_run, parse_config

    for B in (5, 15):
        check_stages(device, B, norm="groupnorm")
    for name, overrides, batch in P17_CHECKED:
        run = build_semi_run(parse_config(["-o", "Trainer.name=semi", *overrides]), device=device)
        errs: dict = {}
        with checked_conv_kernels(errs):
            m = run.step(run.state, run.generator)
        torch.cuda.synchronize()
        if not math.isfinite(float(m["total_loss"])):
            raise AssertionError(f"{name} step: total loss {float(m['total_loss'])}")
        if not any(s[0] == batch for s in errs.get("conv3x3_stats", {}).get("shapes", ())):
            raise AssertionError(f"{name}: K1 not checked at batch {batch}: {errs}")
        for k in (*CONV_KERNELS, *BWD_KERNELS):
            e = errs.get(k)
            if e is None:
                raise AssertionError(f"{name}: {k} not launched: {errs}")
            print(f"  {name}: {k} at {sorted(e['shapes'])}: max_abs_err {e['err']:.3e} "
                  f"({e['rel']:.2f} of its limit)")
            if e["rel"] > 1.0:
                raise AssertionError(f"{name}: {k} disagrees with its plain version")
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e["err"])
        del run
        gc.collect()
        torch.cuda.empty_cache()


def run_optim_steps(device, card: str) -> dict:
    """Phase 17b: per optimizer and schedule, one warm-up and one timed
    full-width ``semi`` step through ``build_semi_run``: finite losses,
    parameters moved, the launches of two semi steps."""
    import gc

    import torch
    from contrastyou_tpu_torch.main import build_semi_run, parse_config

    by_path = {}
    for optim, sched in P17_OPTIMS:
        name = f"semi/{optim}/{sched}"
        run = build_semi_run(parse_config([
            "-o", "Trainer.name=semi", f"Optim.name={optim}", f"+Scheduler.name={sched}",
            "+Scheduler.milestones=[20,40]", "Optim.lr=0.0001"]), device=device)
        before = {k: v.detach().clone() for k, v in run.state.model.named_parameters()}
        torch.cuda.synchronize()
        _reset_counts()
        warm = run.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = run.run(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = by_path[name] = _counts()
        want = {k: 2 * n for k, n in SEMI_STEP_LAUNCHES.items()}
        losses = [float(m["total_loss"]) for m in warm + timed]
        moved = sum(not torch.equal(before[k], v.detach())
                    for k, v in run.state.model.named_parameters())
        print(f"  {name}: losses {losses}; {ms:.1f} ms for the timed step on {card}; "
              f"{moved}/{len(before)} tensors moved; lr {run.state.optimizer.schedule(2):.3e} "
              f"after two updates; launches {counts}")
        if (not all(math.isfinite(v) for v in losses) or not moved
                or {k: counts[k] for k in want} != want):
            raise AssertionError(f"{name}: losses {losses}, {moved} tensors moved, "
                                 f"launches {counts}, want {want}")
        STEP_MS[name] = ms
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def run_unet2(device, card: str) -> None:
    """Phase 17c: UNet2 at its default width (dim 16, mults 1/2/4/8), batch
    10 at 224x224, f32 (as JAX's, which has no dtype field): one warm-up and
    one timed forward + backward; finite logits and gradients, every
    parameter reached."""
    import torch
    from contrastyou_tpu_torch.models import get_arch

    gen = torch.Generator(device=device).manual_seed(17)
    net = get_arch("unet2", input_dim=1, num_classes=4).to(device).init_weights(gen)
    x = torch.rand(10, 224, 224, 1, generator=gen, device=device)
    proj = torch.randn(10, 224, 224, 4, generator=gen, device=device)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_counts()
    for timed in (False, True):
        net.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, taps = net(x)
        (out * proj).mean().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    grads = [p.grad for p in net.parameters()]
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"  unet2: logits {tuple(out.shape)}, {ms:.1f} ms for the timed forward + backward on "
          f"{card}; peak {peak:.2f} GiB; {sum(g is not None for g in grads)}/{len(grads)} "
          f"parameters reached; hand kernels launched {sum(_counts().values())}")
    if (out.shape != (10, 224, 224, 4) or taps or not bool(torch.isfinite(out).all())
            or any(g is None or not bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError("unet2: wrong shape, taps, or a missing or non-finite gradient")
    if any(_counts().values()):
        raise AssertionError(f"unet2 launched hand kernels: {_counts()}")
    STEP_MS["unet2"] = ms


def check_phase17_run(path, run_dir, records: list, launches: dict, eval_counts: dict,
                      card: str, peak: float) -> None:
    """Phase 17d: one path's files, finite ``storage.csv`` values, what the
    path must hold (the ResUNet's residual blocks, no running statistics in
    the GroupNorm net, MultiSteps' count of inner updates), the launches
    (per step x steps, plus each eval forward's), ms/step and peak memory."""
    from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint

    pretrain = "pretrain" in path
    csv_lines = (run_dir / "storage.csv").read_text().splitlines()
    header = csv_lines[0].split(",")
    rows = [{k: float(v) for k, v in zip(header, line.split(",")) if k and v}
            for line in csv_lines[1:]]
    files = [".success", "last/train_state.pt"] + ([] if pretrain else ["inference_result.json"])
    missing = [f for f in files if not (run_dir / f).exists()]
    if missing or len(rows) != P17_EPOCHS or not all(
            math.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"{path}: missing {missing}, {len(rows)} rows, or a non-finite "
                             f"value in storage.csv")
    saved = load_checkpoint(run_dir / "last", map_location="cpu")["train_state"]
    model = saved["model"]
    train = [r for r in records if r["phase"] == "train"]
    steps = sum(r["steps"] for r in train)
    held = {"resunet/semi": "_Conv5.ResidualBlock_1.Conv_1.weight" in model,
            "resunet/pretrain_decoder": "_Conv1.ResidualBlock_0.Conv_2.weight" in model,
            "groupnorm/semi": not any(k.endswith("running_mean") for k in model)
            and "_Conv1.conv.1.weight" in model,
            "semi/accumulate": saved["optimizer_count"] * 2 == saved["step"] == steps,
            "semi/one_stage": saved["optimizer_count"] == saved["step"] == steps}[path]
    if not held:
        raise AssertionError(f"{path}: the checkpoint does not hold what the path must "
                             f"(optimizer count {saved['optimizer_count']}, step {saved['step']})")
    fwd = sum(r["batches"] for r in records if r["phase"] in ("val", "test", "inference"))
    k1, k2 = P17_EVAL.get(path, (8, 1))
    want = {k: n * steps for k, n in P17_LAUNCHES[path].items()}
    want["conv3x3_stats"] += k1 * fwd
    want["upconv3x3_stats"] += k2 * fwd
    want = {k: want.get(k, 0) for k in launches}
    ms = [r["seconds"] / r["steps"] * 1e3 for r in train]
    last = {k.split("/metrics/")[-1] if "/metrics/" in k else k: v for k, v in rows[-1].items()
            if k.startswith("tra/") and ("loss" in k or "/metrics/" in k)}
    print(f"{path}: {len(rows)} storage rows, last {last}; train "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms/step inside the loop on {card}; peak "
          f"{peak:.2f} GiB above the process's; {fwd} eval forwards; launches {launches}")
    if launches != want or eval_counts.get("conv3x3_stats", 0) != k1 * fwd:
        raise AssertionError(f"{path}: launches {launches} (eval {eval_counts}), want {want}")
    STEP_MS[path] = ms[-1]


def run_phase17(device, card: str, recs: dict, extra=()) -> dict:
    """Phase 17: 17a the kernels at the new call sites, 17b the optimizers
    and schedules, 17c UNet2, then each path of P17_PATHS through
    ``main.main`` on phase 15's layout with the counts set to 0 just before
    it and read just after (17d)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like

    print("phase 17a: the GroupNorm net's stages, and semi steps with every kernel launch "
          "checked:")
    check_phase17_kernels(device, recs)
    print("phase 17b: one full-width semi step per optimizer and schedule:")
    by_path = run_optim_steps(device, card)
    print("phase 17c: UNet2 forward + backward:")
    run_unet2(device, card)
    torch.cuda.empty_cache()
    saved_paths = package.DATA_PATH, package.RUN_PATH
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p17_") as tmp:
            data, runs = Path(tmp) / "data", Path(tmp) / "runs"
            synthesize_acdc_like(data, num_train_scans=P15_SCANS[0], num_val_scans=P15_SCANS[1],
                                 slices_per_scan=P15_SLICES, size=P15_SIZE)
            package.DATA_PATH, package.RUN_PATH = str(data), str(runs)
            for path, argv in P17_PATHS:
                save = path.replace("/", "_")
                eval_counts: dict = {}
                timings.records.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                _reset_counts()
                t0 = time.perf_counter()
                with eval_launches(eval_counts):
                    if port_main.main(["-o", *argv, f"Trainer.max_epoch={P17_EPOCHS}",
                                       f"Trainer.num_batches={P17_STEPS}",
                                       f"Trainer.save_dir={save}", *extra]) != 0:
                        raise AssertionError(f"{path}: main returned non-zero")
                torch.cuda.synchronize()
                by_path[path] = _counts()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                print(f"{path}: {time.perf_counter() - t0:.1f} s")
                check_phase17_run(path, runs / save, timings.records, by_path[path],
                                  eval_counts, card, peak)
    finally:
        logger.removeHandler(timings)
        package.DATA_PATH, package.RUN_PATH = saved_paths
    return by_path


# --- phases 18 and 19: data parallelism ---------------------------------------

#: ranks, slices a rank (labeled and unlabeled each), steps a path
DP_WORLD, DP_BATCH, DP_STEPS = 2, 5, 3
#: the data-parallel paths, (name, overrides of ``parse_config``), each on
#: ``DP_WORLD`` ranks of ``DP_BATCH`` + ``DP_BATCH`` slices (``ft``: the
#: labeled batch alone) against one process at the global batch: phase 18's
#: ``semi/dp`` (consistency and the encoder InfoNCE hook on Conv5 by
#: partition), then phase 19's hooks and trainers beyond ``semi``
P19_PATHS = [
    ("semi/dp", ["Trainer.name=semi", "+InfonceParams.feature_names=Conv5",
                 "+InfonceParams.weights=0.5", "+InfonceParams.contrast_ons=partition",
                 "+InfonceParams.spatial_size=1"]),
    ("mt/dp", ["Trainer.name=mt"]),
    ("uamt/dp", ["Trainer.name=mt", *MT_OVERRIDES["uamt"], "+UAMeanTeacherParameters.num_noise=2"]),
    ("ict/dp", ["Trainer.name=mt", *MT_OVERRIDES["ict"]]),
    ("semi/udaiic/dp", ["Trainer.name=semi", "~ConsistencyParameters",
                        "+DiscreteMIConsistencyParams.feature_names=[Conv5,Up_conv2]",
                        "+DiscreteMIConsistencyParams.mi_weights=[0.1,0.05]",
                        "+DiscreteMIConsistencyParams.dense_paddings=[1]",
                        "+DiscreteMIConsistencyParams.consistency_weight=1"]),
    ("semi/dense/dp", ["Trainer.name=semi", "+InfonceParams.feature_names=Up_conv2",
                       "+InfonceParams.weights=0.5", "+InfonceParams.contrast_ons=self",
                       "+InfonceParams.spatial_size=16", "+SPInfonceParams.feature_names=Up_conv2",
                       "+SPInfonceParams.weights=0.2", "+SPInfonceParams.contrast_ons=self",
                       "+SPInfonceParams.begin_values=4", "+SPInfonceParams.end_values=10"]),
    ("ft/dp", ["Trainer.name=ft", "+EvalEMAParameters.alpha=0.99"]),
]
#: launches per step of a rank: (forwards, backward passes) of the net (the
#: teacher's forwards included: MT one, UAMT a clean and two noisy, ICT two
#: and the student's mixed pass, whose backward replaces the unlabeled
#: pass's), plus D1/D2 once per step on the InfoNCE hooks' gathered anchors
#: (``semi/dp``'s 2N = 20 encoder anchors, ``semi/dense/dp``'s dense hook;
#: the self-paced loss is eager) and E1/E2 once on the dense udaiic hook
P19_LAUNCHES = {
    "semi/dp": dict(passes_launches(2, 2), supcon_loss=1, supcon_dz=1),
    "mt/dp": passes_launches(3, 2), "uamt/dp": passes_launches(5, 2),
    "ict/dp": passes_launches(5, 2),
    "semi/udaiic/dp": dict(passes_launches(2, 2), iic_joints=1, iic_joints_bwd=1),
    "semi/dense/dp": dict(passes_launches(2, 2), supcon_loss=1, supcon_dz=1),
    "ft/dp": passes_launches(1, 1)}
#: the path whose rank also times one all-reduce of its gradient bucket and
#: of one BatchNorm's [2, 512] sums
COLLECTIVES_PATH = "semi/dp"


def p19_config(overrides: list, batch: int) -> dict:
    from contrastyou_tpu_torch.main import parse_config
    return parse_config(["-o", *overrides, f"LabeledLoader.batch_size={batch}",
                         f"UnlabeledLoader.batch_size={batch}"])


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _loss_key(metrics: dict) -> str:
    """The step's whole loss: ``total_loss``, or the pretrain step's
    ``reg_loss``."""
    return "total_loss" if "total_loss" in metrics else "reg_loss"


def _first_step(run) -> dict:
    """One step of ``run`` -> its total loss, the gradients of the model's
    and the hooks' parameters, and the hooks' states after it (the
    teachers, the EMA), f32 on the host."""
    import torch
    m = run.run(1)[0]
    out = {"loss": m[_loss_key(m)].reshape(1).float().cpu(),
           **{k: p.grad.float().cpu() for k, p in run.state.model.named_parameters()
              if p.grad is not None}}
    for h in run.hooks:
        if isinstance(h, torch.nn.Module):
            out.update({f"{h.name}/{k}": p.grad.float().cpu() for k, p in h.named_parameters()
                        if p.grad is not None})
        out.update({f"{h.name} state/{k}": v.float().cpu() for k, v in _state_tensors(
            run.state.hook_states[h.name]).items()})
    return out


def _time_all_reduces(run, group) -> dict:
    """ms of one all-reduce of ``run``'s gradient bucket (every optimized
    parameter) and of one BatchNorm's [2, 512] sums, over ``group``."""
    import torch
    import torch.distributed as dist

    bucket = torch.cat([p.detach().reshape(-1) for g in run.state.optimizer.param_groups
                        for p in g["params"]])
    small = torch.zeros(2, 512, device=group.device)
    times = {"bucket": bucket.numel()}
    for name, x, n in (("allreduce_ms", bucket, 5), ("small_allreduce_ms", small, 50)):
        dist.all_reduce(x, group=group.process_group)
        _sync(group.device)
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(x, group=group.process_group)
        _sync(group.device)
        times[name] = (time.perf_counter() - t0) / n * 1e3
    return times


def _build_run(overrides: list, batch: int, device, group=None, **kw):
    """``build_pretrain_run`` for a path of ``P20_PRETRAIN``'s (its
    one-process contrastive batch, cut over ``group``), else
    ``build_semi_run`` at ``batch`` + ``batch`` slices (a rank's)."""
    from contrastyou_tpu_torch.main import build_pretrain_run, build_semi_run, parse_config
    if any(o in PRETRAIN_NAMES for o in overrides):
        return build_pretrain_run(parse_config(["-o", *overrides]), device=device,
                                  data_group=group, **kw)
    return build_semi_run(p19_config(overrides, batch), device=device, data_group=group, **kw)


#: the collectives a rank ran, by kind (:func:`_count_collectives`)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def _count_collectives() -> None:
    """Count every ``torch.distributed`` all-reduce and all-gather of this
    process in :data:`COLLECTIVES` (the port's collectives call them
    through the module)."""
    import torch.distributed as dist

    for kind in COLLECTIVES:
        fn = getattr(dist, kind)

        def counted(*args, _fn=fn, _kind=kind, **kwargs):
            COLLECTIVES[_kind] += 1
            return _fn(*args, **kwargs)

        setattr(dist, kind, counted)


def p19_path(overrides: list, batch: int, device, group=None, steps: int = DP_STEPS,
             collectives: bool = False, **sizes) -> dict:
    """One data-parallel path at ``batch`` + ``batch`` slices (a rank's, with
    ``group``; a pretrain path at its contrastive batch): the first step's
    loss, gradients and hook states, then ``steps - 1`` timed steps; the
    launches and the collectives over all of them; digests of the
    parameters and of the hooks' states; with ``collectives``, the times of
    :func:`_time_all_reduces` after the steps."""
    import hashlib

    import torch

    run = _build_run(overrides, batch, device, group, **sizes)
    before = {k: p.detach().clone() for k, p in run.state.model.named_parameters()}
    _reset_counts()
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
    first = _first_step(run)
    _sync(device)
    t0 = time.perf_counter()
    metrics = run.run(steps - 1)
    _sync(device)
    ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
    launches = _counts()
    per_step = {k: v / steps for k, v in COLLECTIVES.items()}

    def digest(tensors) -> str:
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

    hook_tensors = [v for h in run.hooks for k, v in sorted(_state_tensors(
        run.state.hook_states[h.name]).items())]
    return {"first": first, "ms": ms, "launches": launches, "collectives": per_step,
            "losses": [float(first["loss"])] + [float(m[_loss_key(m)]) for m in metrics],
            "changed": sum(int(not torch.equal(before[k], p.detach()))
                           for k, p in run.state.model.named_parameters()),
            "tensors": len(before),
            "digest": digest(run.state.model.parameters()),
            "hook_digest": digest(hook_tensors) if hook_tensors else None,
            "hooks": [h.name for h in run.hooks], "batch_slices": run.batch_slices,
            **(_time_all_reduces(run, group) if collectives and group is not None else {})}


def _state_tensors(tree, prefix: str = "") -> dict:
    """The tensors of a hook state's nest of dicts, keyed by path."""
    import torch
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_tensors(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def p19_rank(rank: int, world: int, port: int, backend: str, devices: list, out: str,
             sizes: dict) -> None:
    """One rank of phases 18-20 (a spawned process): every path in turn."""
    import torch
    import torch.distributed as dist
    from contrastyou_tpu_torch.parallel import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                             backend=backend, device=devices[rank])
    _count_collectives()
    try:
        results = {}
        for path, overrides in DP_PATHS:
            results[path] = p19_path(overrides, DP_BATCH, group.device, group,
                                     collectives=path == COLLECTIVES_PATH, **sizes)
            if group.device.type == "cuda":
                torch.cuda.empty_cache()
        torch.save({"paths": results, "device": str(group.device)}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_dp(device, card: str, world: int = DP_WORLD, **sizes) -> dict:
    """Phases 18-20: each path of ``DP_PATHS`` on ``world`` ranks
    spawned once, held against one process at the global batch: the first
    step's loss, the model's and the hooks' gradients and the hooks' states
    after it, through the kernels, against f32 (plain kernels), the ranks'
    error at most ``STAGE_FACTOR`` times the one process's plus
    ``STAGE_ATOL``; the ranks' parameters and hook states bitwise equal
    after the steps; the launches per rank of ``DP_LAUNCHES``; the
    collectives a step; ms/step of both. ``sizes`` go to ``build_semi_run``
    and ``build_pretrain_run`` (full width without them)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(world)]
        staging = "NCCL, a card a rank"
    else:
        backend, devices = "gloo", [str(device)] * world
        staging = ("gloo with every rank on one device: each collective is staged through "
                   "host memory by ProcessGroupGloo")
    print(f"data parallelism: {world} ranks spawned once, backend {backend} ({staging}); "
          f"ranks' devices {devices}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(p19_rank, args=(world, port, backend, devices, tmp, sizes), nprocs=world,
                 join=True)
        print(f"data parallelism: ranks done in {time.perf_counter() - t0:.1f} s")
        ranks = [torch.load(f"{tmp}/rank{r}.pt")["paths"] for r in range(world)]

    by_path = {}
    for path, overrides in DP_PATHS:
        one = p19_path(overrides, world * DP_BATCH, device, **sizes)
        with plain_kernels(), plain_supcon(), plain_iic():
            f32 = _first_step(_p19_f32_run(overrides, world * DP_BATCH, device, **sizes))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        got, ref = ranks[0][path]["first"], one["first"]
        if set(got) != set(f32) or set(ref) != set(f32):
            raise AssertionError(f"{path}: the first step's tensors differ from f32's: "
                                 f"{sorted(set(got) ^ set(f32))}")
        worst = {}
        for k in f32:
            ek, ep = _rel_err(got[k], f32[k])[1], _rel_err(ref[k], f32[k])[1]
            kind = "state" if " state/" in k else "loss and gradients"
            worst[kind] = max(worst.get(kind, 0.0), ek / (ep + STAGE_ATOL))
            if ek > STAGE_FACTOR * ep + STAGE_ATOL or not bool(torch.isfinite(got[k]).all()):
                raise AssertionError(f"{path} step 1 {k}: {world} ranks {ek:.3e} from f32, one "
                                     f"process {ep:.3e}")
        loss_err = [_rel_err(x["loss"], f32["loss"])[1] for x in (got, ref)]
        digests = {(r[path]["digest"], r[path]["hook_digest"]) for r in ranks}
        if len(digests) != 1:
            raise AssertionError(f"{path}: the ranks' parameters or hook states differ after "
                                 f"{DP_STEPS} steps")
        want = {k: 0 for k in (*CONV_KERNELS, *BWD_KERNELS, *SUPCON_KERNELS, *IIC_KERNELS)}
        want.update({k: DP_STEPS * n for k, n in DP_LAUNCHES[path].items()})
        for r, res in enumerate(ranks):
            res = res[path]
            if not all(math.isfinite(v) for v in res["losses"]) or res["changed"] == 0:
                raise AssertionError(f"{path} rank {r}: losses {res['losses']}, "
                                     f"{res['changed']} tensors changed")
            if res["launches"] != want:
                raise AssertionError(f"{path} rank {r}: launches {res['launches']}, want {want}")
        res = ranks[0][path]
        hook_grads = sum(1 for k in f32 if any(k.startswith(f"{h}/") for h in res["hooks"]))
        print(f"{path}: hooks {res['hooks']}; step 1 on {world} ranks vs one process, each "
              f"against f32: loss {loss_err[0]:.2e} vs {loss_err[1]:.2e}; over the loss and "
              f"{len(f32) - 1} gradients and hook-state tensors ({hook_grads} of the hooks' "
              f"heads) the ranks' error at most "
              f"{', '.join(f'{v:.2f}x ({k})' for k, v in worst.items())} the one process's "
              f"(+{STAGE_ATOL}; limit {STAGE_FACTOR}x); parameters and hook states bitwise "
              f"equal on the ranks after {DP_STEPS} steps ({res['changed']}/{res['tensors']} "
              f"tensors changed); losses {res['losses']}; launches per rank {res['launches']}")
        if path in P20_NAMES:
            print(f"{path}: hook-state error on {world} ranks / one process's (each against "
                  f"f32, +{STAGE_ATOL}): "
                  + (f"{worst['state']:.2f}x" if "state" in worst else "no hook state")
                  + f"; collectives a step per rank {res['collectives']}")
        slices = (f"a {res['batch_slices']}-slice contrastive batch cut over them"
                  if any(o in PRETRAIN_NAMES for o in overrides)
                  else f"{res['batch_slices']} slices")
        print(f"{path}: {res['ms']:.3f} ms/step on {world} ranks of {slices} "
              f"(rank 1 {ranks[1][path]['ms']:.3f}) vs {one['ms']:.3f} ms/step in one "
              f"process of {one['batch_slices']} ({backend}); on {card}")
        if "bucket" in res:
            print(f"{path}: one all-reduce of the {res['bucket']}-float gradient bucket "
                  f"{res['allreduce_ms']:.3f} ms, of one BatchNorm's [2, 512] sums "
                  f"{res['small_allreduce_ms']:.3f} ms ({backend}); on {card}")
        STEP_MS[path] = res["ms"]
        by_path[path] = res["launches"]
    return by_path


def _p19_f32_run(overrides: list, batch: int, device, **sizes):
    import torch
    return _build_run(overrides, batch, device, dtype=torch.float32, **sizes)


# --- phase 20: the rest of data parallelism -------------------------------------

#: the trainers whose paths run through ``build_pretrain_run``
PRETRAIN_NAMES = ("Trainer.name=pretrain", "Trainer.name=pretrain_decoder")
#: phase 20's paths, in the spawn of phases 18 and 19: the block (cc, rr
#: and imsat on Up_conv2, phase 15's overrides), MixUp, multicore and the
#: two DMT rules of phase 16 at ``DP_BATCH`` + ``DP_BATCH`` slices a rank;
#: then the pretrain step on the one-process contrastive batch cut over
#: the ranks (ACDC's 18 slices, 9 a rank; prostate's 48, 24 a rank, so the
#: global forward is 96 images)
P20_PATHS = [
    ("semi/ccblocks/dp", ["Trainer.name=semi", "~ConsistencyParameters", *P15_CC, *P15_RR,
                          *P15_IMSAT]),
    ("mixup/dp", ["Trainer.name=mixup"]),
    ("multicore/dp", ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01"]),
    ("dmt/dp", ["Trainer.name=dmt"]),
    ("dmt/second_order/dp", ["Trainer.name=dmt", f"{DMT_METHOD}=second_order"]),
    ("pretrain/dp", ["Trainer.name=pretrain"]),
    ("pretrain_cc/dp", ["Trainer.name=pretrain_decoder", *P15_INFONCE_ENCODER, *P15_CC,
                        *P15_RR]),
    ("pretrain_decoder/prostate/dp", ["Trainer.name=pretrain_decoder", "Data.name=prostate"]),
]
P20_NAMES = [p for p, _ in P20_PATHS]
#: launches per step of a rank: the semi paths' passes as in one process
#: (phases 15 and 16); the pretrain step's one forward of both views and its
#: backward (cut at Conv5: K1 on Conv1 and Conv2, C1 on Conv1.conv0, C2 on
#: the 3 other narrow conv inputs; cut at Up_conv2: a whole pass), D1/D2
#: once per InfoNCE hook on its gathered anchors
P20_LAUNCHES = {
    "semi/ccblocks/dp": passes_launches(2, 2), "mixup/dp": passes_launches(2, 2),
    "multicore/dp": passes_launches(2, 2), "dmt/dp": passes_launches(*DMT_PASSES["method1"]),
    "dmt/second_order/dp": SECOND_ORDER_LAUNCHES,
    "pretrain/dp": {"conv3x3_stats": 4, "conv_dw_taps": 1, "conv3x3_bwd_fused": 3,
                    "supcon_loss": 1, "supcon_dz": 1},
    "pretrain_cc/dp": dict(passes_launches(1, 1), supcon_loss=1, supcon_dz=1),
    "pretrain_decoder/prostate/dp": dict(passes_launches(1, 1), supcon_loss=2, supcon_dz=2),
}
#: every data-parallel path of the one spawn, and its launches per step
DP_PATHS = P19_PATHS + P20_PATHS
DP_LAUNCHES = {**P19_LAUNCHES, **P20_LAUNCHES}


CONV_KERNELS = ("conv3x3_stats", "upconv3x3_stats", "upconv3x3_dx")
#: launches per semi step (a batch-5 and a batch-10 forward, each with its
#: backward): K1 the 8 forward convs of each pass (the backward's dx is C2's);
#: C1 Conv1.conv0 and Up2's taps, C2 the 9 other narrow conv inputs, per pass
SEMI_LAUNCHES = {"conv3x3_stats": 16, "conv_dw_taps": 4, "conv3x3_bwd_fused": 18}
BWD_KERNELS = ("conv_dw_taps", "conv3x3_bwd_fused")
SUPCON_KERNELS = ("supcon_loss", "supcon_dz")
IIC_KERNELS = ("iic_joints", "iic_joints_bwd")
SOURCES = {
    "conv3x3_stats": "contrastyou_tpu/ops/pallas/convblock.py:230",
    "upconv3x3_stats": "contrastyou_tpu/ops/pallas/convblock.py:341",
    "upconv3x3_dx": "contrastyou_tpu/ops/pallas/convblock.py:341",
    "supcon_loss": "contrastyou_tpu/ops/pallas/infonce.py:36",
    "supcon_dz": "contrastyou_tpu/ops/pallas/infonce.py:100",
    "conv_dw_taps": "contrastyou_tpu/ops/pallas/convblock.py:628",
    "conv3x3_bwd_fused": "contrastyou_tpu/ops/pallas/convblock.py:768",
    "iic_joints": "contrastyou_tpu/ops/pallas/iic.py:153",
    "iic_joints_bwd": "contrastyou_tpu/ops/pallas/iic.py:183",
}
#: each kernel's source and main path (its ``launches``)
ROUTES = {**{k: ("tapconv.cu", "semi") for k in CONV_KERNELS},
          "supcon_loss": ("supcon.cu", "pretrain_decoder"),
          "supcon_dz": ("supcon.cu", "pretrain_decoder"),
          **{k: ("convbwd.cu", "semi") for k in BWD_KERNELS},
          **{k: ("iic.cu", "semi/udaiic") for k in IIC_KERNELS}}


# --- phase 21: experiment tooling and run observability --------------------------

#: phase 21's cuts, added to the generated commands: 2 epochs x 10 steps (as
#: the other loop phases) on every command; the profiler on the first grid
#: command; on the pretrain command the pretrain split's 4 scans a batch (the
#: layout's 8 train scans, half of them in the pretrain split, against
#: config/pretrain.yaml's ``scan_sample_num`` 6); and of the chain's ft jobs
#: only the first (:data:`P21_FT_RATIO`) runs
P21_CUTS = (f"Trainer.max_epoch={LOOP_EPOCHS}", f"Trainer.num_batches={LOOP_STEPS}")
P21_PROFILE = "+Trainer.profile=true"
P21_PRETRAIN_CUT = "ContrastiveLoaderParams.scan_sample_num=4"
#: the ratio of the chain's one ft job run, its first (ratios 2 and 4 train
#: the same path at more labeled scans; 174 exceeds the layout's 8 train
#: scans)
P21_FT_RATIO = 1
#: launches per train step of ``semi`` with the udaiic hooks
UDAIIC_STEP_LAUNCHES = {**SEMI_STEP_LAUNCHES, "iic_joints": 1, "iic_joints_bwd": 1}
#: launches of one eval forward (8 K1 and 1 K2)
EVAL_FORWARD_LAUNCHES = {"conv3x3_stats": 8, "upconv3x3_stats": 1}
def launched_wrapper(kernel: str):
    """The port's kernel wrapper whose launch ran the CUDA function
    ``kernel`` (a trace event's name), or None (a library, PyTorch or a
    partial-sum kernel)."""
    if "tapmma_kernel<" in kernel:     # <Cout, Cin, KIND, NG, MF>: KIND 1 is K2, 2 K3
        kind = kernel.split("tapmma_kernel<", 1)[1].split(",")[2].strip()
        return {"1": "upconv3x3_stats", "2": "upconv3x3_dx"}.get(kind, "conv3x3_stats")
    for fn, wrapper in (("conv1ch_kernel", "conv3x3_stats"), ("dw_mma_kernel<", "conv_dw_taps"),
                        ("dw1ch_kernel<", "conv_dw_taps"),
                        ("convbwd_kernel<", "conv3x3_bwd_fused"),
                        ("supcon_kernel<false", "supcon_loss"), ("supcon_kernel<true", "supcon_dz"),
                        ("iic_joints_bwd_kernel<", "iic_joints_bwd"),
                        ("iic_joints_kernel<", "iic_joints")):
        if fn in kernel:
            return wrapper
    return None


def check_run_events(run_dir) -> int:
    """Every numeric ``storage.csv`` cell of the run is in its events file
    under JAX's tag at step = epoch, equal within float32 rounding; -> the
    scalars checked."""
    import csv
    import numpy as np
    from contrastyou_tpu_torch.writer import read_events, storage_tag

    files = sorted((run_dir / "tensorboard").glob("events.out.tfevents.*"))
    if len(files) != 1:
        raise AssertionError(f"{run_dir}: {len(files)} event files")
    scalars = {(e["tag"], e["step"]): e["value"] for e in read_events(files[0])
               if isinstance(e["value"], float)}
    with open(run_dir / "storage.csv", newline="") as f:
        rows = list(csv.reader(f))
    checked = 0
    for row in rows[1:]:
        epoch = int(row[0])
        for column, cell in zip(rows[0][1:], row[1:]):
            if cell == "":
                continue
            got = scalars.get((storage_tag(column), epoch))
            if got is None or got != np.float32(float(cell)):
                raise AssertionError(f"{run_dir}: {column} epoch {epoch}: events {got}, "
                                     f"storage.csv {cell}")
            checked += 1
    if checked != len(scalars) or checked == 0:
        raise AssertionError(f"{run_dir}: {len(scalars)} scalars in the events, {checked} "
                             f"numeric storage cells")
    return checked


def check_trace(run_dir, card: str, want_window: dict) -> dict:
    """The profiled epoch's trace: per hand kernel, its device events (by
    CUDA function name) equal the launch counter's count over the same
    window (``profile/launches.json``), which is what the epoch's train
    steps and eval forwards imply (``want_window``)."""
    trace = run_dir / "profile" / "epoch_001.pt.trace.json"
    counted = json.loads((run_dir / "profile" / "launches.json").read_text())
    t0 = time.perf_counter()
    events = json.loads(trace.read_text())["traceEvents"]
    device = {}
    for e in events:
        if e.get("cat") == "kernel":
            w = launched_wrapper(e.get("name", ""))
            if w is not None:
                device[w] = device.get(w, 0) + 1
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"phase 21 trace: {trace.name} {trace.stat().st_size / 2**20:.1f} MiB, "
          f"{len(events)} events, {kernels} device kernels, parsed in "
          f"{time.perf_counter() - t0:.1f} s; hand kernels by CUDA function {device}")
    launches = counted["launches"]
    if {k: device.get(k, 0) for k in launches} != launches or launches != want_window:
        raise AssertionError(f"profiled epoch: device events {device}, launch counter "
                             f"{launches}, the epoch implies {want_window}")
    return device


def run_phase21(device, card: str) -> dict:
    """Phase 21: a grid and a pretrain -> fine-tune chain generated by the
    port's ``generate_experiments`` and run by its ``SlurmSubmitter``
    (``on_local``, bash, one job after another, each job's output in a log
    file) as ``python -m contrastyou_tpu_torch.main -p <presets>`` processes
    at full width on phase 11's layout; ``P21_*`` are the only cuts. Then
    each run's files, its events against its ``storage.csv``, its launches
    against its steps and eval forwards (``launches.json``, which also holds
    the run's seconds and timing records), the profiled epoch's trace
    against the launch counter, and ``report`` over the runs against their
    ``storage.csv``."""
    import csv
    import tempfile
    from pathlib import Path

    from contrastyou_tpu_torch import generate_experiments as gen, report
    from contrastyou_tpu_torch.submitter import SlurmSubmitter

    repo = Path(__file__).resolve().parent
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p21_") as tmp:
        t0 = time.perf_counter()
        data, runs_root, logs = Path(tmp) / "data", Path(tmp) / "runs", Path(tmp) / "logs"
        write_loop_layout(data)
        logs.mkdir()
        grid = gen.build_commands("udaiic", "acdc", [1], str(runs_root))
        chain = gen.build_chained_commands("infonce_ed_pretrain", "acdc", str(runs_root))[0]
        if len(grid) != 2:
            raise AssertionError(f"udaiic grid: {len(grid)} commands, want 2")
        pre, *fts = chain.split(" && \\\n")
        ratio = re.compile(r"Data\.labeled_scan_num=(\d+)")
        ratios = [int(ratio.search(c).group(1)) for c in fts]
        if ratios[0] != P21_FT_RATIO or ratios[0] > LOOP_SCANS[0]:
            raise AssertionError(f"chain ratios {ratios}: the first is not {P21_FT_RATIO}")
        jobs = [(f"udaiic/run{i}", " ".join([cmd, *P21_CUTS, *([P21_PROFILE] if i == 0 else [])]))
                for i, cmd in enumerate(grid)]
        jobs.append(("infonce_ed_pretrain/run0", " && \\\n".join(
            [" ".join([pre, *P21_CUTS, P21_PRETRAIN_CUT]), " ".join([fts[0], *P21_CUTS])])))
        print(f"phase 21: layout in {time.perf_counter() - t0:.1f} s; {len(grid)} grid commands, "
              f"a chain of 1 pretrain + {len(fts)} ft jobs (ratios {ratios}), of which the "
              f"ratio-{P21_FT_RATIO} job runs; cuts {' '.join(P21_CUTS)}, {P21_PROFILE} on "
              f"udaiic/run0, {P21_PRETRAIN_CUT} on the pretrain job")
        for name, job in jobs:
            log = logs / (name.replace("/", "_") + ".log")
            sub = SlurmSubmitter(work_dir=str(repo), on_local=True)
            sub.configure_environment([
                f"export CONTRASTYOU_DATA_PATH={data}", f"export CONTRASTYOU_RUN_PATH={runs_root}",
                "unset CONTRASTYOU_PROFILE", f'python() {{ "{sys.executable}" "$@"; }}',
                f"exec >{log} 2>&1"])
            t1 = time.perf_counter()
            try:
                sub.submit(job)
            except RuntimeError as e:
                tail = log.read_text()[-4000:] if log.exists() else "(no log)"
                raise AssertionError(f"phase 21 job {name} failed:\n{tail}") from e
            print(f"phase 21 job {name}: {job.count('contrastyou_tpu_torch.main')} runs in "
                  f"{time.perf_counter() - t1:.1f} s on {card}")
        run_dirs = sorted(p.parent for p in runs_root.rglob("launches.json")
                          if p.parent.name != "profile")
        if len(run_dirs) != 4:
            raise AssertionError(f"phase 21: runs {run_dirs}, want 4")
        profiled_dir = runs_root / re.search(r"Trainer\.save_dir=(\S+)", grid[0]).group(1)
        finished = []
        for run_dir in run_dirs:
            path = "p21/" + str(run_dir.relative_to(runs_root))
            for f in (".success", "storage.csv", "config.yaml", "last/train_state.pt"):
                if not (run_dir / f).exists():
                    raise AssertionError(f"{path}: {f} missing")
            record = json.loads((run_dir / "launches.json").read_text())
            counts, trainer, timing = record["launches"], record["trainer"], record["timing"]
            by_path[path] = counts
            train = [t for t in timing if t["phase"] == "train"]
            evals = [t for t in timing if t["phase"] in ("val", "test", "inference")]
            steps = sum(t["steps"] for t in train)
            fwd = sum(t["batches"] for t in evals)
            if trainer == "pretrain_decoder":
                per_step, want = CHAIN_LAUNCHES["pretrain_decoder/loop"], {}
                positive = CONV_KERNELS + BWD_KERNELS + SUPCON_KERNELS
            else:
                per_step = UDAIIC_STEP_LAUNCHES if trainer == "semi" else \
                    CHAIN_LAUNCHES["ft/loop"]
                want = {k: n * fwd for k, n in EVAL_FORWARD_LAUNCHES.items()}
                positive = CONV_KERNELS + BWD_KERNELS
                finished.append(run_dir)
            for k, n in per_step.items():
                want[k] = want.get(k, 0) + n * steps
            zero = [k for k in counts if k not in positive and k not in per_step]
            if (any(counts[k] != v for k, v in want.items()) or any(counts[k] for k in zero)
                    or min(counts[k] for k in positive) <= 0):
                raise AssertionError(f"{path}: launches {counts}, want {want} ({steps} steps, "
                                     f"{fwd} eval forwards), {zero} zero, {positive} > 0")
            scalars = check_run_events(run_dir)
            ms = ", ".join(f"epoch {t['epoch']} {t['seconds'] / t['steps'] * 1e3:.3f}"
                           f"{' (profiled)' if t['profiled'] else ''}" for t in train)
            events = ", ".join(f"epoch {t['epoch']} {t['bytes']} B in {t['seconds'] * 1e3:.3f} ms"
                               for t in timing if t["phase"] == "events")
            phases = {}
            for t in timing:
                phases[t["phase"]] = phases.get(t["phase"], 0.0) + t["seconds"]
            split = ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
            print(f"{path} ({trainer}): {record['seconds']:.1f} s in run_experiment ({split} s); "
                  f"train ms/step {ms}; events {events} ({scalars} scalars = storage.csv); "
                  f"{steps} steps, {fwd} eval forwards; launches {counts} on {card}")
            profile = [t for t in timing if t["phase"] == "profile"]
            if (run_dir == profiled_dir) != bool(profile):
                raise AssertionError(f"{path}: profile records {profile}, profiled run "
                                     f"{profiled_dir}")
            if profile:
                (prof,) = profile
                epoch = prof["epoch"]
                window = {k: 0 for k in counts}
                for k, n in per_step.items():
                    window[k] += n * sum(t["steps"] for t in train if t["epoch"] == epoch)
                val_test = sum(t["batches"] for t in evals
                               if t["epoch"] == epoch and t["phase"] in ("val", "test"))
                for k, n in EVAL_FORWARD_LAUNCHES.items():
                    window[k] += n * val_test
                check_trace(run_dir, card, window)
                print(f"{path}: profile of epoch {epoch}: {prof['bytes'] / 2**20:.1f} MiB, "
                      f"{prof['device_events']} device events, written in "
                      f"{prof['seconds']:.3f} s")
        rows = report.main(["-t", str(runs_root), "--classes", "DSC_mean", "--save_dir",
                            str(Path(tmp) / "report")])
        if sorted(r["folder"] for r in rows) != sorted(str(d) for d in finished):
            raise AssertionError(f"report rows {[r['folder'] for r in rows]}, runs {finished}")
        for row in rows:
            # the expected row from the plain csv module, empty cells skipped
            with open(Path(row["folder"]) / "storage.csv", newline="") as f:
                header, *cells = list(csv.reader(f))
            col = next(i for i, c in enumerate(header) if "DSC_mean" in c)
            values = [(int(r[0]), float(r[col])) for r in cells if r[col] != ""]
            best = max(v for _, v in values)
            epoch = next(e for e, v in values if v == best)
            if row["best_epoch"] != epoch or row[header[col]] != best:
                raise AssertionError(f"report {row} against storage.csv: epoch {epoch}, {best}")
        print(f"phase 21 report: {len(rows)} rows (best epoch and {header[col]} as storage.csv)")
    return by_path


# --- phase 22: the last modules -------------------------------------------------

#: phase 22's layout: 12 train scans (6 in the pretrain split: the 18-slice
#: ACDC contrastive batch) and 18 validation scans (8 in the validation split:
#: the plot's 8 dumped batches), 10 slices at 256x256
P22_SCANS, P22_SLICES, P22_SIZE = (12, 18), 10, 256
#: the plot entry's argv after ``-o`` (the udaiic preset cut to the decoder)
P22_PLOT_ARGV = ["DiscreteMIConsistencyParams.feature_names=[Up_conv2]",
                 "DiscreteMIConsistencyParams.mi_weights=[0.05]",
                 f"Trainer.max_epoch={LOOP_EPOCHS}", f"Trainer.num_batches={LOOP_STEPS}",
                 "Trainer.save_dir=plot"]
#: launches of one decoder-pretraining step with the dense IIC hook (one
#: forward over both views cut at Up_conv2, its backward, E1 and E2), and of
#: one full forward of the dump
PLOT_STEP_LAUNCHES = {"conv3x3_stats": 8, "upconv3x3_stats": 1, "upconv3x3_dx": 1,
                      "conv_dw_taps": 2, "conv3x3_bwd_fused": 9, "iic_joints": 1,
                      "iic_joints_bwd": 1}
#: the E1/E2 shape of the plot path: the Up_conv2 taps of 18 slices
PLOT_IIC_SHAPE = (18, 224, 224, 32)
#: launches of one monitor pass batch on pretrain_decoder (InfoNCE on Conv5 and
#: Up_conv2): the forward cut at Up_conv2 and the two losses, no backward
MONITOR_LAUNCHES = {"conv3x3_stats": 8, "upconv3x3_stats": 1, "supcon_loss": 2}
#: the loader comparison: the orders of the host-fed (prefetch 4 / None) and
#: device-cached train epochs, in turns, and the steps of each of their 2 epochs
P22_FEEDS = ("prefetch", "sync", "cached", "sync", "prefetch")
P22_FEED_STEPS = 20
#: fast_crop's timed batches (32 slices, 224^2, 8 threads)
FAST_CROP_BATCH, FAST_CROP_THREADS, FAST_CROP_BATCHES, FAST_CROP_SIZE = 32, 8, 20, 224


def write_p22_layout(root) -> None:
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
    synthesize_acdc_like(root, num_train_scans=P22_SCANS[0], num_val_scans=P22_SCANS[1],
                         slices_per_scan=P22_SLICES, size=P22_SIZE)


def run_plot_entry(data, runs_root, card: str) -> dict:
    """22a: the plot entry as a process; -> its launches (train, dump)."""
    import numpy as np
    from pathlib import Path
    from contrastyou_tpu_torch.data.png import read_png

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, CONTRASTYOU_DATA_PATH=str(data), CONTRASTYOU_RUN_PATH=str(runs_root))
    env.pop("CONTRASTYOU_PROFILE", None)
    cmd = [sys.executable, "-m", "contrastyou_tpu_torch.plot_pretrain_cluster", "-p",
           str(repo / "config/base.yaml"), str(repo / "config/hooks/udaiic.yaml"), "-o",
           *P22_PLOT_ARGV]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"plot entry failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out = Path(runs_root) / "plot" / "cluster_plots"
    metrics = json.loads((out / "cluster_metrics.json").read_text())
    record = json.loads((out / "launches.json").read_text())
    if list(metrics) != ["discreteMI/up_conv2"]:
        raise AssertionError(f"plot: cluster hooks {list(metrics)}")
    m = metrics["discreteMI/up_conv2"]
    mapping = {int(k): v for k, v in m["mapping"].items()}
    if not 0.0 <= m["cluster_acc"] <= 1.0 or sorted(mapping) != sorted(mapping.values()):
        raise AssertionError(f"plot: cluster_acc {m['cluster_acc']}, mapping {mapping}")
    maps = sorted(out.glob("discreteMI_up_conv2_b*.npy"))
    if len(maps) != 8:
        raise AssertionError(f"plot: {len(maps)} maps, want 8 (the validation batches)")
    shapes = {np.load(f).shape for f in maps}
    montages = [read_png(f.with_suffix(".png"), rgb=True) for f in maps]
    tsne_png = read_png(out / "discreteMI_up_conv2_tsne.png", rgb=True)
    if tsne_png.shape != (900, 900, 3) or any(a.ndim != 3 for a in montages):
        raise AssertionError(f"plot: t-SNE PNG {tsne_png.shape}")
    steps = LOOP_EPOCHS * LOOP_STEPS
    want_train = {k: n * steps for k, n in PLOT_STEP_LAUNCHES.items()}
    want_dump = {k: n * len(maps) for k, n in EVAL_FORWARD_LAUNCHES.items()}
    launches = record["launches"]
    for phase, want in (("train", want_train), ("dump", want_dump)):
        got = launches[phase]
        if any(got.get(k, 0) != want.get(k, 0) for k in set(got) | set(want)):
            raise AssertionError(f"plot {phase} launches {got}, want {want}")
    tsne = record["tsne"]["discreteMI/up_conv2"]
    if tsne["n"] != len(maps) * P22_SLICES or not math.isfinite(tsne["kl_divergence"]):
        raise AssertionError(f"plot t-SNE {tsne}")
    ms = ", ".join(f"{t['seconds'] / t['steps'] * 1e3:.3f}" for t in record["timing"]
                   if t["phase"] == "train")
    print(f"plot entry: {seconds:.1f} s as a process (training {record['seconds']['train']:.1f} "
          f"s, {ms} ms/step by epoch; dump {record['seconds']['dump']:.1f} s); cluster_acc "
          f"{m['cluster_acc']:.4f}, "
          f"{len(mapping)} ids mapped; maps {sorted(shapes)}; t-SNE of N = {tsne['n']} pooled "
          f"features in {tsne['seconds']:.3f} s, exact KL {tsne['kl_divergence']:.6f} after "
          f"{tsne['n_iter'] + 1} iterations; launches train {launches['train']}, dump "
          f"{launches['dump']} on {card}")
    return {"plot/train": launches["train"], "plot/dump": launches["dump"]}


def check_default_preset_refused(data, runs_root) -> None:
    """22c: the documented udaiic preset raises before training."""
    from pathlib import Path
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch.plot_pretrain_cluster import main as plot_main

    repo = Path(__file__).resolve().parent
    saved = package.DATA_PATH, package.RUN_PATH
    package.DATA_PATH, package.RUN_PATH = str(data), str(runs_root)
    try:
        plot_main(["-p", str(repo / "config/base.yaml"), str(repo / "config/hooks/udaiic.yaml"),
                   "-o", "Trainer.save_dir=plot_default"])
    except NotImplementedError as e:
        if "discreteMI/conv5" not in str(e):
            raise AssertionError(f"default udaiic preset: {e}") from e
        if (Path(runs_root) / "plot_default" / "last").exists():
            raise AssertionError("default udaiic preset: trained before refusing")
        print(f"plot entry, default udaiic preset: refused before training ({str(e)[:96]}...)")
    else:
        raise AssertionError("default udaiic preset: no refusal")
    finally:
        package.DATA_PATH, package.RUN_PATH = saved


def check_monitor_pass(device, card: str, **sizes) -> dict:
    """22d: the monitor pass on pretrain_decoder changes nothing (``sizes``:
    ``build_pretrain_run``'s, full width by default)."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.steps import point_grids
    from contrastyou_tpu_torch.main import PRETRAIN_DECODER_CONFIG, build_pretrain_run
    from contrastyou_tpu_torch.trainers.pretrain import build_monitor_step, sample_pretrain_draws

    run = build_pretrain_run(PRETRAIN_DECODER_CONFIG, device=device, **sizes)
    run.run(2)
    gen = torch.Generator(device=device).manual_seed(7)
    n = run.batch_slices
    batch = run.cache.sample(gen, n)
    draws = sample_pretrain_draws(gen, n, point_grids=point_grids(run.hooks),
                                  total_freedom=False)
    crop = run.cache.crop
    monitor = build_monitor_step(ModelBundle(run.state.model, (crop, crop, 1)), run.hooks,
                                 until=run.until)

    def snapshot():
        opt = run.state.optimizer
        return ({k: v.clone() for k, v in run.state.model.state_dict().items()},
                {f"{h.name}/{k}": v.clone() for h in run.hooks if isinstance(h, torch.nn.Module)
                 for k, v in h.state_dict().items()},
                repr(run.state.hook_states),
                [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in st.items()}
                 for st in opt.state.values()], opt.count, run.state.step)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    before = snapshot()
    sync()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = monitor(run.state, batch, draws)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    after = snapshot()
    for a, b, what in ((before[0], after[0], "model"), (before[1], after[1], "heads")):
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        if bad:
            raise AssertionError(f"monitor pass changed {what} {bad[:5]}")
    if before[2] != after[2] or before[4:] != after[4:] or len(before[3]) != len(after[3]) or any(
            not (torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k])
            for x, y in zip(before[3], after[3]) for k in x):
        raise AssertionError("monitor pass changed the hook states or the optimizer")
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"monitor metrics {metrics}")
    want = {k: MONITOR_LAUNCHES.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"monitor launches {launches}, want {want}")
    print(f"monitor pass (pretrain_decoder, batch {n}): reg_loss "
          f"{float(metrics['reg_loss']):.5f}, model / BN statistics / heads / hook states / "
          f"optimizer ({len(before[3])} states, count {before[4]}) bitwise unchanged, "
          f"{ms:.3f} ms (first call); launches {launches} on {card}")
    return {"monitor/pretrain_decoder": launches}


def run_feeds(data, runs_root, device, card: str) -> dict:
    """22e: the semi loop's train epochs (2 x ``P22_FEED_STEPS``) host-fed with the
    prefetch thread, host-fed in the calling thread, and device-cached, in
    the turns of ``P22_FEEDS``; -> ms/step of each turn's second epoch."""
    import hashlib
    import torch
    from contrastyou_tpu_torch import main as port_main
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.trainers import trainer_zoo

    config = port_main.parse_config(["-o", "Trainer.name=semi"])
    seed = int(config["RandomSeed"])
    timings = _Timings()
    logger = logging.getLogger("contrastyou_tpu_torch")
    logger.addHandler(timings)
    level = logger.level
    logger.setLevel(logging.INFO)
    result, fed = {}, {}
    by_path = {}
    try:
        for turn, feed in enumerate(P22_FEEDS):
            labeled, unlabeled, _, _ = get_data(config["Data"], config["LabeledLoader"],
                                                config["UnlabeledLoader"], root_dir=str(data))
            for loader in (labeled, unlabeled):
                loader.prefetch = 4 if feed == "prefetch" else None
            gen = torch.Generator(device=device).manual_seed(seed)
            model = port_main._model(config, device, torch.bfloat16, None, gen)
            trainer = trainer_zoo["semi"](
                model=model, labeled_loader=labeled, unlabeled_loader=unlabeled,
                config=config, seed=seed, save_dir=str(runs_root / f"feed{turn}"),
                max_epoch=LOOP_EPOCHS, num_batches=P22_FEED_STEPS, device_cache=feed == "cached")
            trainer.register_hooks(*port_main._hooks(config, model, device, torch.bfloat16, gen,
                                                     is_pretrain=False, trainer=trainer))
            trainer.init()
            digests = []
            host_batch = trainer._host_batch

            def record(lab, unlab, _hb=host_batch, _d=digests):
                _d.append(hashlib.sha1(lab["image"].tobytes() + unlab["image"].tobytes()
                                       + lab["target"].tobytes()).hexdigest())
                return _hb(lab, unlab)

            trainer._host_batch = record
            timings.records.clear()
            _reset_counts()
            with trainer._closing_iterators():
                for epoch in range(LOOP_EPOCHS):
                    trainer.tra_epoch(epoch)
            by_path[f"semi/feed/{feed}{turn}"] = _counts()
            train = [r for r in timings.records if r["phase"] == "train"]
            ms = train[-1]["seconds"] / train[-1]["steps"] * 1e3
            result.setdefault(feed, []).append(ms)
            if feed != "cached":
                fed.setdefault(feed, []).append(digests)
            del trainer, model
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(timings)
        logger.setLevel(level)
    streams = [d for runs in fed.values() for d in runs]
    if any(d != streams[0] for d in streams) or len(streams[0]) != LOOP_EPOCHS * P22_FEED_STEPS:
        raise AssertionError("host-fed batches differ between prefetch 4 and the calling thread")
    want = {k: n * LOOP_EPOCHS * P22_FEED_STEPS for k, n in SEMI_STEP_LAUNCHES.items()}
    for path, counts in by_path.items():
        if any(counts.get(k, 0) != want.get(k, 0) for k in set(counts) | set(want)):
            raise AssertionError(f"{path} launches {counts}, want {want}")
    print(f"semi loop feeds (second epoch, ms/step, in turns {P22_FEEDS}): " + "; ".join(
        f"{k} {', '.join(f'{v:.3f}' for v in vs)}" for k, vs in result.items())
        + f"; the {len(streams)} host-fed runs' {len(streams[0])} batches identical on {card}")
    return by_path


def check_fast_crop(data, card: str) -> None:
    """22f: fast_crop against the numpy crop and scale, and its rate."""
    import itertools
    import numpy as np
    from contrastyou_tpu_torch.data.base import normalize_u8
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.data.loader import BatchLoader
    from contrastyou_tpu_torch.data.sampler import InfiniteRandomSampler

    ds = get_data({"name": "acdc", "labeled_scan_num": P22_SCANS[0] // 2}, {}, {},
                  root_dir=str(data))[0].dataset
    c = FAST_CROP_SIZE
    crop = (c, c, "random")

    def loader(fast):
        return BatchLoader(ds, sampler=InfiniteRandomSampler(len(ds), seed=4),
                           batch_size=FAST_CROP_BATCH, seed=4, prefetch=None,
                           fast_crop=crop if fast else None, num_threads=FAST_CROP_THREADS)

    t0 = time.perf_counter()
    first = next(iter(loader(True)))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(4 ^ 0x5F5E1)
    idx = list(itertools.islice(iter(InfiniteRandomSampler(len(ds), seed=4)), FAST_CROP_BATCH))
    ys = rng.integers(0, P22_SIZE - c + 1, FAST_CROP_BATCH)
    xs = rng.integers(0, P22_SIZE - c + 1, FAST_CROP_BATCH)
    for j, (i, y, x) in enumerate(zip(idx, ys, xs)):
        img, gt = ds._preload["img"][i], ds._preload["gt"][i]
        if not (np.array_equal(first["image"][j, ..., 0], normalize_u8(img[y:y + c, x:x + c]))
                and np.array_equal(first["target"][j], gt[y:y + c, x:x + c])):
            raise AssertionError(f"fast_crop slice {j} differs from the numpy crop")
    rates = {}
    for name, fast in (("fast_crop", True), ("item path", False), ("fast_crop", True)):
        it = iter(loader(fast))
        next(it)
        t0 = time.perf_counter()
        for _ in range(FAST_CROP_BATCHES):
            next(it)
        rates.setdefault(name, []).append(
            FAST_CROP_BATCHES * FAST_CROP_BATCH / (time.perf_counter() - t0))
    print(f"fast_crop: {FAST_CROP_BATCH} slices exact against the numpy crop and scale (first "
          f"batch with the build {build_s:.2f} s); slices/s at {FAST_CROP_BATCH} x {c}^2, "
          f"{FAST_CROP_THREADS} threads: " + "; ".join(
              f"{k} {', '.join(f'{v:.0f}' for v in vs)}" for k, vs in rates.items())
          + f" on {card}")


def run_phase22(device, card: str, recs: dict) -> dict:
    import tempfile
    from pathlib import Path
    import torch

    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p22_") as tmp:
        data, runs_root = Path(tmp) / "data", Path(tmp) / "runs"
        t0 = time.perf_counter()
        write_p22_layout(data)
        print(f"phase 22: layout ({P22_SCANS[0]} train, {P22_SCANS[1]} validation scans of "
              f"{P22_SLICES} slices at {P22_SIZE}^2) in {time.perf_counter() - t0:.1f} s")
        by_path.update(run_plot_entry(data, runs_root, card))
        print(f"dense-IIC kernels vs plain at the plot path's taps {PLOT_IIC_SHAPE}:")
        for k, r in check_iic(device, shape=PLOT_IIC_SHAPE, paddings=(1,)).items():
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], r["max_abs_err"])
            recs[k].setdefault("by_shape", {})[str(list(PLOT_IIC_SHAPE))] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}
        torch.cuda.empty_cache()
        check_default_preset_refused(data, runs_root)
        by_path.update(check_monitor_pass(device, card))
        torch.cuda.empty_cache()
        by_path.update(run_feeds(data, runs_root, device, card))
        check_fast_crop(data, card)
    return by_path


# --- phase 23: K train steps a call, one CUDA graph a call -----------------------------

#: steps a call (the JAX bench's UNROLL) and the calls of a graph run: the
#: first is the eager warm-up, the second captures and replays, the third
#: replays (timed against as many eager steps)
P23_UNROLL, P23_CALLS = 8, 3
#: (path, its config, host-fed): ``semi`` + consistency device-cached and
#: host-fed, then the udaiic hooks (E1/E2 in the graph), MT and ICT (the
#: EMA teacher updated in place; ICT's draws from the host generator)
#: then DMT's rules but ``method1`` and ``second_order`` (``P23_EXTRA``'s)
P23_DMT_RULES = ("mt", "method2", "method3", "method4")
P23_PATHS = [("semi/unroll", "semi", False), ("semi/unroll/host", "semi", True),
             ("semi/udaiic/unroll", "udaiic", False), ("mt/unroll", "mt", False),
             ("ict/unroll", "ict", False),
             *((f"dmt/{m}/unroll", f"dmt/{m}", False) for m in P23_DMT_RULES)]
#: the entry point's run of phase 23: a short epoch of two graph calls
P23_MAIN_ARGV = ["-o", "Trainer.name=semi", f"Trainer.unroll_steps={P23_UNROLL}",
                 "Trainer.device_cache=true", "Trainer.max_epoch=2",
                 f"Trainer.num_batches={2 * P23_UNROLL}", "Trainer.save_dir=unroll"]


#: the paths ``python3 chip_smoke.py unroll`` drives by default (phase 23's
#: check on the other trainers that take K)
P23_EXTRA = ("ft", "uamt", "mixup", "multicore", "dmt", "dmt/second_order", "ccblocks")
#: the overrides of the trainers phase 23 can also drive (``ft``, MixUp,
#: multicore, DMT's default rule and ``second_order``, the cc block with its
#: dynamic IMSAT weight under ``semi``)
P23_OVERRIDES = {"ft": ["Trainer.name=ft"], "mixup": ["Trainer.name=mixup"],
                 "multicore": ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01"],
                 "dmt": ["Trainer.name=dmt"],
                 **{f"dmt/{m}": ["Trainer.name=dmt", f"{DMT_METHOD}={m}"]
                    for m in ("second_order", *P23_DMT_RULES)},
                 "ccblocks": ["Trainer.name=semi", "~ConsistencyParameters", *P15_CC, *P15_RR,
                              *P15_IMSAT]}


def p23_config(kind: str, unroll: int):
    from contrastyou_tpu_torch.main import UDAIIC_CONFIG, parse_config
    extra = [f"Trainer.unroll_steps={unroll}"]
    if kind == "udaiic":
        return parse_config(["-o", "Trainer.name=semi", *extra], UDAIIC_CONFIG)
    if kind in MT_OVERRIDES:
        return _mt_config(kind, *extra)
    return parse_config(["-o", *P23_OVERRIDES.get(kind, ["Trainer.name=semi"]), *extra])


class P23Feed:
    """Phase 23's host-fed ``semi`` steps: numpy batches cropped from the
    run's synthetic split with a seeded numpy generator, sent through pinned
    memory as the trainer sends them, and the step's draws from the run's
    generators; the eager side steps ``build_train_step``, the graph side
    ``build_unrolled_train_step``. On a ``group`` of W ranks (phase 24b)
    each rank crops its own rows from a generator seeded with its rank and
    keeps its rows of the global batch's draws."""

    def __init__(self, run, device, unroll: int, seed: int = 5, group=None):
        import numpy as np
        from contrastyou_tpu_torch.engine.bundle import ModelBundle
        from contrastyou_tpu_torch.engine.steps import (build_train_step,
                                                        build_unrolled_train_step)
        self.run, self.device, self.unroll, self.group = run, device, unroll, group
        self.world = 1 if group is None else group.size
        self.rng = np.random.default_rng(seed + (0 if group is None else group.rank))
        #: each call's stacked labeled images (K > 1)
        self.log: list = []
        self.split = [(c.images.cpu().numpy(), c.targets.cpu().numpy(), c.crop)
                      for c in (run.labeled_cache, run.unlabeled_cache)]
        bundle = ModelBundle(run.state.model, (self.split[0][2], self.split[0][2], 1))
        self.step = (build_train_step(bundle, run.hooks, data_group=group) if unroll == 1 else
                     build_unrolled_train_step(bundle, run.hooks, unroll=unroll,
                                               data_group=group))

    def _crop(self, which: int, n: int):
        images, targets, c = self.split[which]
        idx = self.rng.integers(0, len(images), n)
        oy, ox = (self.rng.integers(0, images.shape[k] - c + 1, n) for k in (1, 2))
        return (idx, [images[i, y:y + c, x:x + c] for i, y, x in zip(idx, oy, ox)],
                [targets[i, y:y + c, x:x + c] for i, y, x in zip(idx, oy, ox)])

    def _one(self):
        import numpy as np
        import torch
        from contrastyou_tpu_torch.engine.steps import sample_step_draws, shard_step_draws

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                self.device, non_blocking=True)

        idx, img, tgt = self._crop(0, 5)
        _, uimg, _ = self._crop(1, 5)
        # [..., None] of a fresh stack: the channel axis's stride as a
        # stacked row's (the backward's kernels on the CPU read it)
        batch = {"labeled_image": dev(np.stack([i[..., None] for i in img])),
                 "labeled_target": dev(np.stack(tgt)),
                 "unlabeled_image": dev(np.stack([i[..., None] for i in uimg]))}
        def whole(x):
            return (x.shape[0] * self.world, *x.shape[1:])

        shape = whole(batch["unlabeled_image"])
        draws = sample_step_draws(self.run.generator, shape[0], self.run.hooks,
                                  host_rng=self.run.host_rng, shape=shape,
                                  labeled_shape=whole(batch["labeled_image"]))
        return batch, shard_step_draws(draws, self.run.hooks, self.group), torch.as_tensor(idx)

    def __call__(self):
        import torch
        from contrastyou_tpu_torch.engine.steps import stack_batches
        state = self.run.state
        if self.unroll == 1:
            batch, draws, idx = self._one()
            m = _with_lr(state, self.step(state, batch, draws))
            m["labeled_scan_id"] = idx
            return m
        parts = [self._one() for _ in range(self.unroll)]
        batches = stack_batches([b for b, _, _ in parts])
        self.log.append(batches["labeled_image"].clone())
        m = self.step(state, batches, [d for _, d, _ in parts])
        m["labeled_scan_id"] = torch.stack([i for _, _, i in parts])
        return m


def _with_lr(state, m: dict) -> dict:
    m["lr"] = state.optimizer.lr.clone()
    return m


def _p23_state(run) -> dict:
    """name -> tensor of what the steps change: parameters, BN statistics,
    optimizer moments, hook state tensors."""
    import torch
    out = {f"model.{k}": v.detach() for k, v in run.state.model.state_dict().items()}
    for i, st in enumerate(run.state.optimizer.state.values()):
        out.update({f"opt{i}.{k}": v for k, v in st.items()})
    for name, st in run.state.hook_states.items():
        for k, v in (st or {}).items():
            items = v.items() if isinstance(v, dict) else [("", v)]
            out.update({f"{name}.{k}.{j}": x for j, x in items if isinstance(x, torch.Tensor)})
    return out


def _record_draws(cache, log: list) -> None:
    """Log the batch indices each step draws from ``cache``."""
    draw = cache.draw

    def recorded(generator, n):
        out = draw(generator, n)
        log.append(out[0].clone())
        return out

    cache.draw = recorded


def _p23_run(kind: str, host: bool, unroll: int, device, steps: int, timed: int) -> dict:
    """``steps`` train steps of the ``kind`` run, ``unroll`` a call, the
    last ``timed`` timed with CUDA events (and the host clock)."""
    import torch
    from contrastyou_tpu_torch.main import build_semi_run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run = build_semi_run(p23_config(kind, unroll), device=device)
    start = {k: v.clone() for k, v in _p23_state(run).items()}
    drawn: list = []
    if host:
        feed = P23Feed(run, device, unroll)
    else:
        _record_draws(run.labeled_cache, drawn)

        def feed():
            m = run.step(run.state, run.generator, 0, run.host_rng)
            return _with_lr(run.state, m) if unroll == 1 else m
    _reset_counts()
    got, statics, capture_s, graph = [], [], None, None
    calls = steps // unroll
    for c in range(calls):
        if c == calls - timed // unroll:
            torch.cuda.synchronize()
            t_start = torch.cuda.Event(enable_timing=True)
            t_start.record()
            t0 = time.perf_counter()
        tc = time.perf_counter()
        m = feed()
        if unroll > 1:
            graph = feed.step.graph if host else run.step.graph
            if c == 1:
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - tc
            statics.append([v.clone() for v in graph._statics if isinstance(v, torch.Tensor)])
        got.append(m if unroll > 1 else {k: v[None] for k, v in m.items()})
    t_end = torch.cuda.Event(enable_timing=True)
    t_end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / timed * 1e3
    metrics = {k: torch.cat([m[k].reshape(m[k].shape[0], -1) for m in got])
               for k in ("total_loss", "lr")}
    ids = (torch.cat([m["labeled_scan_id"].reshape(-1, 5) for m in got]) if host
           else torch.stack(drawn))
    return {"loss": metrics["total_loss"][:, 0].double(), "lr": metrics["lr"][:, 0],
            "ids": ids.cpu(), "launches": _counts(), "state": _p23_state(run),
            "ms": t_start.elapsed_time(t_end) / timed, "wall_ms": wall,
            "peak": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            "graph": graph, "statics": statics, "schedule": run.state.optimizer.schedule,
            "step": run.state.step, "capture_s": capture_s, "run": run, "start": start,
            "feed": feed,
            # what each call's replay must find in the graph's inputs
            "inputs": ([[b] for b in feed.log] if host else
                       [drawn[c * unroll:(c + 1) * unroll] for c in range(calls)])}


def _p23_compare(e: dict, g: dict) -> dict:
    """Run ``g`` against run ``e`` of as many steps: losses (bitwise count,
    the first step apart, worst relative), state tensors (bitwise count,
    the difference's L2 over every float tensor in units of the L2 of what
    ``e``'s steps changed, the worst tensor relative to its largest value);
    integer state equal."""
    import torch
    le, lg = e["loss"], g["loss"]
    out = {"loss_rel": ((lg - le).abs() / le.abs().clamp(min=1e-30)).max().item(),
           "losses_bitwise": int((lg == le).sum()),
           "first_apart": next((i + 1 for i in range(len(le)) if lg[i] != le[i]), None)}
    worst, worst_key, same, n, diff2, upd2 = 0.0, None, 0, 0, 0.0, 0.0
    for k, v in e["state"].items():
        w = g["state"][k]
        if not v.is_floating_point():
            if not torch.equal(v, w):
                raise AssertionError(f"{k}: {v.tolist()} against {w.tolist()}")
            continue
        r = (w.double() - v.double()).abs().max().item() / max(
            v.double().abs().max().item(), 1e-30)
        if r > worst:
            worst, worst_key = r, k
        diff2 += (w.double() - v.double()).pow(2).sum().item()
        v0 = e["start"].get(k)            # optimizer moments are made at the first step
        upd2 += (v.double() - (0.0 if v0 is None else v0.double())).pow(2).sum().item()
        same += int(torch.equal(v, w))
        n += 1
    out.update(state_rel=math.sqrt(diff2 / max(upd2, 1e-300)), worst_tensor=[worst_key, worst],
               state_bitwise=same, state_tensors=n)
    return out


def p23_path(path: str, kind: str, host: bool, device, card: str,
             profiled: bool = False) -> dict:
    """One path of phase 23: from one state and one seed, P23_CALLS x K
    eager steps at K = 1 and P23_CALLS calls at K = P23_UNROLL, held
    against each other (losses and every state tensor at KERNEL_RTOL, the
    draws each step consumed, the learning rates, the launches); the last
    call timed against the last K eager steps with CUDA events.
    ``profiled``: the busy share
    of one more call and of as many eager steps. Returns the graph run's
    launches and its record."""
    import torch

    K, calls = P23_UNROLL, P23_CALLS
    steps = K * calls
    e = _p23_run(kind, host, 1, device, steps, K)
    g = _p23_run(kind, host, K, device, steps, K)
    cmp = _p23_compare(e, g)
    rel, state_rel, first = cmp["loss_rel"], cmp["state_rel"], cmp["first_apart"]
    bitwise, (worst_key, worst) = cmp["losses_bitwise"], cmp["worst_tensor"]
    same, n = cmp["state_bitwise"], cmp["state_tensors"]
    timed = K
    graph = g["graph"]
    per_graph = graph.launches_per_graph
    print(f"{path}: {steps} eager steps vs {calls} calls of {K} (call 1 the eager warm-up, "
          f"call 2 the capture ({g['capture_s']:.2f} s with its replay); {graph.replays} "
          f"replays): losses {bitwise}/{steps} bitwise (first apart: step {first}), worst rel "
          f"{rel:.2e}; {same}/{n} state tensors bitwise, the difference {state_rel:.2e} of the "
          f"steps' change in L2 (worst tensor {worst_key}, {worst:.2e} of its largest); "
          f"launches per graph {per_graph}; "
          f"the last {timed} steps (a replay): eager {e['ms']:.3f} ms/step, graph "
          f"{g['ms']:.3f} ms/step "
          f"({e['ms'] / g['ms']:.2f}x; CUDA events; host clock {e['wall_ms']:.3f} / "
          f"{g['wall_ms']:.3f}); peak {e['peak']:.2f} / {g['peak']:.2f} GiB above the process's "
          f"on {card}")
    if rel > KERNEL_RTOL or state_rel > KERNEL_RTOL:
        raise AssertionError(f"{path}: graph vs eager loss rel {rel:.2e}, state {state_rel:.2e} "
                             f"of the steps' change (limit {KERNEL_RTOL})")
    # the draws: each step's equal to the eager step's; the last two replays'
    # their own, and in the graph's input buffers at their replay
    if not torch.equal(e["ids"], g["ids"]):
        raise AssertionError(f"{path}: batch indices {g['ids'].tolist()} graph, "
                             f"{e['ids'].tolist()} eager")
    r1, r2 = slice(steps - 2 * K, steps - K), slice(steps - K, steps)
    if torch.equal(g["ids"][r1], g["ids"][r2]) or torch.equal(g["loss"][r1], g["loss"][r2]):
        raise AssertionError(f"{path}: replay {graph.replays} repeats replay "
                             f"{graph.replays - 1}'s draws (frozen in the graph)")
    for c in (calls - 2, calls - 1):
        want = g["inputs"][c]
        if not all(any(s.shape == i.shape and torch.equal(s, i) for s in g["statics"][c])
                   for i in want):
            raise AssertionError(f"{path}: call {c + 1}'s draws are not in the graph's inputs")
    lr_want = torch.tensor([e["schedule"](i) for i in range(steps)], dtype=torch.float64)
    for name, lr in (("graph", g["lr"]), ("eager", e["lr"])):
        if ((lr.double().cpu() - lr_want).abs() / lr_want).max().item() > 1e-12:
            raise AssertionError(f"{path}: {name} lr {lr.tolist()} vs schedule {lr_want.tolist()}")
    if not g["step"] == e["step"] == steps or g["launches"] != e["launches"]:
        raise AssertionError(f"{path}: step {g['step']} / {e['step']}, launches graph "
                             f"{g['launches']} vs eager {e['launches']}")
    if any(per_graph.get(k, 0) * calls != v for k, v in e["launches"].items()) or not per_graph:
        raise AssertionError(f"{path}: {per_graph} a graph of {K} steps vs {e['launches']} in "
                             f"{steps} eager steps")
    if profiled:
        rec_idle = {"eager": _busy_share(lambda: [e["feed"]() for _ in range(K)], K),
                    "graph": _busy_share(g["feed"], K)}
        print(f"{path} profiled window of {K} steps on {card}: {rec_idle}")
    STEP_MS[path] = g["ms"]
    rec = {"eager_ms": e["ms"], "graph_ms": g["ms"], "eager_wall_ms": e["wall_ms"],
           "graph_wall_ms": g["wall_ms"], "capture_s": g["capture_s"],
           "launches_per_graph": per_graph, "eager_peak_gib": e["peak"],
           "graph_peak_gib": g["peak"], **cmp}
    if profiled:
        rec["idle"] = rec_idle
    launches = g["launches"]
    del e, g
    torch.cuda.empty_cache()
    return {"launches": launches, "record": rec}


def _busy_share(step, steps: int) -> dict:
    """The device's busy share of ``step()`` (``steps`` train steps) under
    torch.profiler, per step; "not measured" when the trace has no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if not kernels:
        return "not measured"
    busy = sum(ev.time_range.elapsed_us() for ev in kernels)
    return {"busy_ms_per_step": busy / steps / 1e3, "wall_ms_per_step": wall / steps / 1e3,
            "idle_share": 1 - busy / wall, "kernels_per_step": len(kernels) / steps}


def run_phase23(device, card: str) -> dict:
    """Phase 23: ``Trainer.unroll_steps`` = 8 at full width; each path of
    P23_PATHS held graph against eager (``p23_path``; on ``semi`` also the
    device's busy share), then the entry point once for two short epochs
    of two graph calls (the files, finite rows, C1 and C2 launched as 2 x
    16 ``semi`` steps imply)."""
    import tempfile
    from pathlib import Path

    import torch
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main

    by_path, recs = {}, {}
    for path, kind, host in P23_PATHS:
        r = p23_path(path, kind, host, device, card, profiled=path == "semi/unroll")
        by_path[path], recs[path] = r["launches"], r["record"]
    saved_paths = package.DATA_PATH, package.RUN_PATH
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p23_") as tmp:
            data = Path(tmp) / "data"
            write_loop_layout(data)
            package.DATA_PATH, package.RUN_PATH = str(data), str(Path(tmp) / "runs")
            root = Path(__file__).resolve().parent
            argv = ["-p", str(root / "config/base.yaml"),
                    str(root / "config/hooks/consistency.yaml"), *P23_MAIN_ARGV]
            _reset_counts()
            t0 = time.perf_counter()
            if port_main.main(argv) != 0:
                raise AssertionError("semi/unroll/main: main returned non-zero")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = by_path["semi/unroll/main"] = _counts()
            run_dir = Path(tmp) / "runs" / "unroll"
            rows = (run_dir / "storage.csv").read_text().splitlines()
            values = [float(v) for row in rows[1:] for v in row.split(",")[1:] if v]
            steps = 2 * 2 * P23_UNROLL
            print(f"semi/unroll/main: {seconds:.1f} s, {len(rows) - 1} storage rows, launches "
                  f"{launches} ({steps} steps)")
            if not (run_dir / ".success").exists() or len(rows) != 3:
                raise AssertionError(f"semi/unroll/main: .success or storage.csv rows {rows}")
            if not all(math.isfinite(v) for v in values):
                raise AssertionError(f"semi/unroll/main: non-finite storage {rows}")
            for k in BWD_KERNELS:
                if launches[k] != steps * SEMI_LAUNCHES[k]:
                    raise AssertionError(f"semi/unroll/main: {k} {launches[k]} in {steps} steps")
    finally:
        package.DATA_PATH, package.RUN_PATH = saved_paths
    print("phase 23 records: " + json.dumps(recs))
    return by_path


# --- phase 24: chunked evaluation, one CUDA graph a chunk; K steps a call on ranks ---------

#: phase 24a's validation scans: P24_EACH of each slice count (44 scans, one
#: pass a chunk of 32 and one of 12 padded to 32, every batch 20 slices)
P24_SLICES, P24_EACH, P24_TRAIN_SCANS = (8, 12, 16, 20), 11, 4
#: 24a's trainers, (path, overrides, train steps before the passes): ``semi``
#: + consistency with a K = 8 train graph on the device cache (its eval
#: graph captured into the train graph's memory pool), ``mt`` evaluated on
#: its teacher after two steps, ``multicore`` (``prob_transform``)
P24_EVAL = [("semi/eval", ["Trainer.name=semi", "Trainer.unroll_steps=8",
                           "Trainer.device_cache=true", "Trainer.num_batches=16"], True),
            ("mt/eval", ["Trainer.name=mt", "Trainer.device_cache=true",
                         "Trainer.num_batches=2"], True),
            ("multicore/eval", ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01"],
             False)]
#: 24b: the paths on DP_WORLD ranks at K = P23_UNROLL against K = 1, (path,
#: overrides, host-fed)
P24_DP = [("semi/dp/unroll", P19_PATHS[0][1], False), ("semi/dp/unroll/host", P19_PATHS[0][1], True),
          ("mt/dp/unroll", ["Trainer.name=mt"], False),
          ("dmt/dp/unroll", ["Trainer.name=dmt"], False)]
#: 24b: calls of K = 8 (the last call timed against the last 8 of as many
#: one-step calls)
P24_DP_CALLS = 1
#: 24b: the sharded eval against one process's: the loss's relative
#: difference (the numerators summed over the ranks in another order) and
#: the DSC's (a bf16 pixel may round the other way at another batch size,
#: moving one scan's dice by ~1/|union| ~ 1e-6 here)
P24_EVAL_LOSS_RTOL, P24_EVAL_DSC_ATOL = 1e-5, 1e-4


def write_p24_layout(root) -> None:
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
    for i, n in enumerate(P24_SLICES):
        synthesize_acdc_like(root, num_train_scans=P24_TRAIN_SCANS if i == 0 else 0,
                             num_val_scans=P24_EACH, slices_per_scan=n, size=LOOP_SIZE, seed=i,
                             first_scan=1 if i == 0 else P24_TRAIN_SCANS + i * P24_EACH + 1)


def p24_batches(root) -> list:
    """Every validation scan of the layout as one eval batch (padded to the
    longest), read once: the passes time the staging and the device."""
    from contrastyou_tpu_torch.data.creator import create_tra_test_dataset
    from contrastyou_tpu_torch.data.loader import BatchLoader
    from contrastyou_tpu_torch.data.sampler import ScanBatchSampler
    _, test = create_tra_test_dataset("acdc", str(root))
    return list(BatchLoader(test, batch_sampler=ScanBatchSampler(test, shuffle=False),
                            infinite=False))


def p24_trainer(path: str, overrides: list, device, group=None):
    from contrastyou_tpu_torch import main as port_main
    cfg = port_main.parse_config(["-o", *overrides, "Trainer.max_epoch=1",
                                  f"Trainer.save_dir=p24_{path.replace('/', '_')}"])
    return port_main.build_trainer(cfg, device=device, data_group=group)


def _stage(chunk: list, device) -> list:
    import numpy as np
    import torch
    return [torch.from_numpy(np.stack([b[k] for b in chunk])).to(device)
            for k in ("image", "target", "mask")]


def _by_scan(outs: list, names: list, sums: dict) -> None:
    """Add a chunk's per-row counts to ``sums`` by scan name."""
    inter, union = (x.reshape(-1, x.shape[-1]).cpu() for x in outs[1:])
    for i, name in enumerate(names):
        if name is not None:
            a, b = sums.setdefault(name, [0, 0])
            sums[name] = [a + inter[i], b + union[i]]


def _dsc(sums: dict):
    import torch
    return {k: ((2 * a.double() + 1e-16) / (b.double() + 1e-16)) for k, (a, b) in sums.items()}


def p24_eval(path: str, overrides: list, train: bool, batches: list, device, card: str,
             timed: bool = True) -> dict:
    """24a on one trainer: its train epoch (``train``), then three
    ``eval_epoch`` passes over ``batches`` (the first chunk the eager
    warm-up, the second the capture and its replay, then replays):
    captures, replays, launches (each pass
    chunks x 32 x (8 K1 + 1 K2)), ms a scan and peak memory of each; every
    chunk replayed against its eager run on the same device tensors,
    bitwise (losses, counts, per-scan DSC), the passes' statistics equal;
    with ``timed``, timed against the eager chunks and the per-scan path
    (``build_eval_step`` a scan, as before chunking). On ``semi`` the memory
    an eval capture adds in the train graph's pool and in a pool of its
    own."""
    import torch
    from contrastyou_tpu_torch.engine.graph import GraphPool
    from contrastyou_tpu_torch.engine.steps import build_scanned_eval_step

    gib = 2 ** 30
    trainer = p24_trainer(path, overrides, device)
    if train:
        trainer.tra_epoch(0)
    model = trainer._inference_state()
    teacher = model is not trainer._model
    scanned = trainer._scanned_eval()
    graph = scanned.graph
    n = len(batches)
    K = trainer.EVAL_CHUNK
    chunks = list(trainer._eval_chunks(batches))
    want = {k: len(chunks) * K * v for k, v in EVAL_FORWARD_LAUNCHES.items()}
    passes = []
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        _reset_counts()
        t0 = time.perf_counter()
        stats, score = trainer.eval_epoch(batches, 0, "val")
        torch.cuda.synchronize()
        passes.append({"ms_scan": (time.perf_counter() - t0) / n * 1e3, "stats": stats,
                       "launches": _counts(), "captures": graph.captures,
                       "replays": graph.replays,
                       "peak_gib": (torch.cuda.max_memory_allocated() - base) / gib,
                       "reserved_added_gib": (torch.cuda.memory_reserved() - reserved) / gib})
        got = {k: passes[-1]["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{path} pass {i + 1}: launches {got}, want {want}")
    # every chunk has one shape: the first call is the warm-up, the second
    # (pass 1's second chunk) captures, every later call replays
    captures = [1 if len(chunks) > 1 else 0, 1, 1]
    if ([p["captures"] for p in passes] != captures
            or passes[-1]["replays"] != 3 * len(chunks) - 1):
        raise AssertionError(f"{path}: captures {[p['captures'] for p in passes]}, replays "
                             f"{passes[-1]['replays']} (want {captures} and "
                             f"{3 * len(chunks) - 1})")
    per_graph = graph.launches_per_graph
    if per_graph != {k: K * v for k, v in EVAL_FORWARD_LAUNCHES.items()}:
        raise AssertionError(f"{path}: a graph launches {per_graph}")
    if not all(p["stats"] == passes[0]["stats"] for p in passes):
        raise AssertionError(f"{path}: the passes' statistics differ: "
                             f"{[p['stats']['eval'] for p in passes]}")
    # each chunk: the replay against the eager chunk on the same tensors
    sums = {"graph": {}, "eager": {}}
    apart = 0
    for chunk, names, _ in chunks:
        x = _stage(chunk, device)
        g = scanned(model, *x)
        e = graph.body(model, *x)
        apart += sum(int((a != b).sum()) for a, b in zip(g, e))
        _by_scan(g, names, sums["graph"])
        _by_scan(e, names, sums["eager"])
    dg, de = _dsc(sums["graph"]), _dsc(sums["eager"])
    if apart or set(dg) != set(de) or not all(torch.equal(dg[k], de[k]) for k in dg):
        raise AssertionError(f"{path}: the replays differ from the eager chunks in {apart} "
                             f"elements")
    if len(dg) != n:
        raise AssertionError(f"{path}: {len(dg)} scans counted of {n}")
    # the eager chunks and the per-scan path, timed
    eager_ms = eager_peak = scan_ms = scan_peak = math.nan
    if timed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for chunk, _, _ in chunks:
            out = graph.body(model, *_stage(chunk, device))
            torch.cat([o.reshape(-1).double() for o in out]).cpu()
        torch.cuda.synchronize()
        eager_ms, eager_peak = ((time.perf_counter() - t0) / n * 1e3,
                                (torch.cuda.max_memory_allocated() - base) / gib)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _, tensors in trainer._eval_batches(batches):
            trainer._eval_step(model, *tensors)
        torch.cuda.synchronize()
        scan_ms, scan_peak = ((time.perf_counter() - t0) / n * 1e3,
                              (torch.cuda.max_memory_allocated() - base) / gib)
    rec = {"scans": n, "chunks": len(chunks), "chunk_shape": list(chunks[0][0][0]["image"].shape),
           "graph_ms_scan": passes[2]["ms_scan"], "pass2_ms_scan": passes[1]["ms_scan"],
           "pass1_ms_scan": passes[0]["ms_scan"], "eager_chunk_ms_scan": eager_ms,
           "per_scan_ms_scan": scan_ms, "captures": graph.captures, "replays": graph.replays,
           "launches_per_graph": per_graph, "launches_per_pass": passes[2]["launches"],
           "graph_peak_gib": passes[2]["peak_gib"], "pass1_peak_gib": passes[0]["peak_gib"],
           "eager_chunk_peak_gib": eager_peak, "per_scan_peak_gib": scan_peak,
           "pass1_reserved_added_gib": passes[0]["reserved_added_gib"],
           "teacher": teacher, "val_dsc_mean": passes[2]["stats"]["eval"]["dice"]["DSC_mean"]}
    train_graph = getattr(trainer._train_step, "graph", None)
    if train_graph is not None and train_graph.replays:
        x = _stage(chunks[0][0], device)
        for name, pool in (("shared", train_graph.pool), ("own", GraphPool())):
            other = build_scanned_eval_step(trainer._bundle, pool=pool, **trainer._eval_kwargs())
            other(model, *x)                        # the warm-up
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            out = other(model, *x)                  # the capture and its replay
            torch.cuda.synchronize()
            rec[f"capture_reserved_{name}_pool_gib"] = (torch.cuda.memory_reserved()
                                                        - before) / gib
            if not all(torch.equal(a, b) for a, b in zip(out, scanned(model, *x))):
                raise AssertionError(f"{path}: the {name}-pool graph differs")
            del other, out
    print(f"{path}: {n} scans as {len(chunks)} chunks of {K} batches {rec['chunk_shape']}"
          f"{' (the teacher)' if teacher else ''}: graph {rec['graph_ms_scan']:.3f} ms a scan "
          f"(pass 1, the warm-up and the capture: {rec['pass1_ms_scan']:.3f}; pass 2 "
          f"{rec['pass2_ms_scan']:.3f}), eager chunks {eager_ms:.3f}, per scan "
          f"{scan_ms:.3f}; {graph.captures} capture, {graph.replays} replays, a graph "
          f"{per_graph}; the replays bitwise equal to the eager chunks (losses, counts, "
          f"{len(dg)} scans' DSC); peak above the process's: graph {rec['graph_peak_gib']:.3f}, "
          f"pass 1 {rec['pass1_peak_gib']:.3f}, eager chunks {eager_peak:.3f}, per scan "
          f"{scan_peak:.3f} GiB; on {card}")
    if "capture_reserved_shared_pool_gib" in rec:
        print(f"{path}: reserved memory an eval capture adds: in the train graph's pool "
              f"{rec['capture_reserved_shared_pool_gib']:.3f} GiB, in a pool of its own "
              f"{rec['capture_reserved_own_pool_gib']:.3f} GiB (its static inputs included)")
    launches = passes[2]["launches"]
    del trainer, model, scanned, graph, chunks
    torch.cuda.empty_cache()
    return {"launches": launches, "record": rec}


def p24_rank(rank: int, world: int, port: int, out: str, data: str) -> None:
    """One rank of 24b (a spawned process, gloo, every rank on cuda:0)."""
    import torch
    import torch.distributed as dist
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch.parallel import init_distributed

    group = init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                             backend="gloo", device="cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _count_collectives()
    package.DATA_PATH, package.RUN_PATH = data, f"{out}/runs"
    try:
        res = {"paths": {}}
        for path, overrides, host in P24_DP:
            res["paths"][path] = {K: p24_dp_run(overrides, host, K, group)
                                  for K in (1, P23_UNROLL)}
            torch.cuda.empty_cache()
        trainer = p24_trainer("semi/dp/eval", ["Trainer.name=semi"], group.device, group)
        batches = p24_batches(data)
        evals = []
        for _ in range(2):                      # the warm-up, the capture and replays
            COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats, _ = trainer.eval_epoch(batches, 0, "val")
            torch.cuda.synchronize()
            evals.append({"stats": stats, "ms_scan": (time.perf_counter() - t0) / len(batches) * 1e3,
                          "collectives": dict(COLLECTIVES)})
        res["eval"] = {"passes": evals, "chunks": len(list(trainer._eval_chunks(batches))),
                       "replays": trainer._scanned_eval().graph.replays,
                       "rows": batches[0]["image"].shape[0] // world}
        torch.save(res, f"{out}/p24_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def p24_dp_run(overrides: list, host: bool, K: int, group) -> dict:
    """P24_DP_CALLS x P23_UNROLL steps of one 24b path on this rank, K a
    call: the losses, every state tensor's digest, ms/step of the last
    P23_UNROLL steps."""
    import hashlib

    import torch
    from contrastyou_tpu_torch.main import build_semi_run

    run = build_semi_run(p19_config([*overrides, f"Trainer.unroll_steps={K}"], DP_BATCH),
                         device=group.device, data_group=group)
    feed = P23Feed(run, group.device, K, group=group) if host else (
        lambda: run.step(run.state, run.generator, 0, run.host_rng))
    steps = P24_DP_CALLS * P23_UNROLL
    losses = []
    for i in range(steps // K):
        if i * K == steps - P23_UNROLL:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        m = feed()
        losses.append(m["total_loss"].reshape(-1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / P23_UNROLL * 1e3
    graph = getattr(feed.step if host else run.step, "graph", None)

    def digest(t):
        return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()

    return {"losses": torch.cat(losses).cpu(), "ms": ms, "step": run.state.step,
            "state": {k: digest(v) for k, v in _p23_state(run).items()},
            "replays": 0 if graph is None else graph.replays}


def run_phase24(device, card: str) -> dict:
    """Phase 24: (a) the chunked eval of ``semi``, ``mt`` (its teacher) and
    ``multicore`` on 44 validation scans at full width (``p24_eval``); (b)
    DP_WORLD gloo ranks on the card: each path of P24_DP at K = P23_UNROLL
    bitwise against K = 1 on the same ranks (losses, every state tensor on
    every rank, the ranks equal), no graph replayed; the sharded chunked
    eval against one process's (loss, DSC), two collectives a chunk."""
    import socket
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp
    import contrastyou_tpu_torch as package

    by_path, recs = {}, {}
    saved_paths = package.DATA_PATH, package.RUN_PATH
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p24_") as tmp:
            data = Path(tmp) / "data"
            t0 = time.perf_counter()
            write_p24_layout(data)
            package.DATA_PATH, package.RUN_PATH = str(data), str(Path(tmp) / "runs")
            batches = p24_batches(data)
            print(f"24a: wrote and read {len(batches)} validation scans of {P24_SLICES} slices "
                  f"in {time.perf_counter() - t0:.1f} s")
            for path, overrides, train in P24_EVAL:
                r = p24_eval(path, overrides, train, batches, device, card,
                             timed=path == P24_EVAL[0][0])
                by_path[path], recs[path] = r["launches"], r["record"]
            one = p24_trainer("semi/one/eval", ["Trainer.name=semi"], device)
            one_stats = [one.eval_epoch(batches, 0, "val")[0] for _ in range(2)]
            del one
            torch.cuda.empty_cache()
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            mp.spawn(p24_rank, args=(DP_WORLD, port, tmp, str(data)), nprocs=DP_WORLD,
                     join=True)
            print(f"24b: {DP_WORLD} gloo ranks on {device} done in "
                  f"{time.perf_counter() - t0:.1f} s")
            ranks = [torch.load(f"{tmp}/p24_rank{r}.pt") for r in range(DP_WORLD)]
    finally:
        package.DATA_PATH, package.RUN_PATH = saved_paths
    for path, _, _ in P24_DP:
        res = [r["paths"][path] for r in ranks]
        one_k, many = res[0][1], res[0][P23_UNROLL]
        same = sum(int(one_k["state"][k] == many["state"][k]) for k in one_k["state"])
        equal_ranks = all(r[P23_UNROLL]["state"] == many["state"] for r in res)
        print(f"{path}: {DP_WORLD} ranks, {P24_DP_CALLS} calls of {P23_UNROLL} against "
              f"{P24_DP_CALLS * P23_UNROLL} steps of 1: losses "
              f"{int((one_k['losses'] == many['losses']).sum())}/{len(many['losses'])} bitwise, "
              f"{same}/{len(one_k['state'])} state tensors bitwise, ranks equal {equal_ranks}; "
              f"{many['ms']:.3f} ms/step at K = {P23_UNROLL} (a loop), {one_k['ms']:.3f} at "
              f"K = 1 (rank 1: {res[1][P23_UNROLL]['ms']:.3f} / {res[1][1]['ms']:.3f}); on {card}")
        if (not torch.equal(one_k["losses"], many["losses"]) or same != len(one_k["state"])
                or not equal_ranks or many["replays"] or many["step"] != one_k["step"]):
            raise AssertionError(f"{path}: K = {P23_UNROLL} on {DP_WORLD} ranks differs from "
                                 f"K = 1 (or replayed a graph: {many['replays']})")
        recs[path] = {"ms": many["ms"], "k1_ms": one_k["ms"]}
    ev = [r["eval"] for r in ranks]
    want, got = one_stats[1]["eval"], ev[0]["passes"][1]["stats"]["eval"]
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    dsc = max(abs(got["dice"][k] - want["dice"][k]) for k in want["dice"])
    per_chunk = {k: v / ev[0]["chunks"] for k, v in ev[0]["passes"][1]["collectives"].items()}
    print(f"semi/dp/eval: {DP_WORLD} ranks of {ev[0]['rows']} rows a batch against one process: "
          f"loss rel {loss_rel:.2e}, DSC worst {dsc:.2e} (one process's DSC_mean "
          f"{want['dice']['DSC_mean']:.4f}); the ranks' statistics equal "
          f"{all(e['passes'][1]['stats'] == ev[0]['passes'][1]['stats'] for e in ev)}; "
          f"collectives a chunk {per_chunk}; {ev[0]['replays']} replays; "
          f"{ev[0]['passes'][1]['ms_scan']:.3f} ms a scan (warm-up pass "
          f"{ev[0]['passes'][0]['ms_scan']:.3f}); on {card}")
    if (loss_rel > P24_EVAL_LOSS_RTOL or dsc > P24_EVAL_DSC_ATOL
            or per_chunk != {"all_reduce": 1, "all_gather": 1}
            or not all(e["passes"][1]["stats"] == ev[0]["passes"][1]["stats"] for e in ev)
            or not ev[0]["replays"]):
        raise AssertionError(f"semi/dp/eval: {DP_WORLD} ranks against one process: loss rel "
                             f"{loss_rel:.2e}, DSC {dsc:.2e}, collectives a chunk {per_chunk}")
    recs["semi/dp/eval"] = {"loss_rel": loss_rel, "dsc_worst": dsc, "collectives": per_chunk,
                            "ms_scan": ev[0]["passes"][1]["ms_scan"]}
    print("phase 24 records: " + json.dumps(recs))
    return by_path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from contrastyou_tpu_torch.ops import _build     # fails outside a checkout
    card = _card()
    print(card)
    torch.backends.cudnn.allow_tf32 = False        # plain versions: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    print(f"built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s")

    print("kernel vs plain (times per launch, CUDA events):")
    recs = check_kernels(device)
    recs.update(check_supcon(device))
    print("SupCon route, fused (D1 + D2) vs eager, value and gradient, d = 256:")
    route = route_sweep(device)
    print("dense-IIC kernels vs plain (f1, f2 [5, 224, 224, 32] bf16, S = 5, K = 20):")
    recs.update(check_iic(device))
    print("backward kernels vs plain (batch 96) and vs the einsum form (batches 5, 10, 36):")
    recs.update(check_bwd_kernels(device))
    for B in (5, BWD_BATCH):
        check_stages(device, B)
    by_path = {"semi": run_train(device, card)}
    by_path["semi/udaiic"] = run_udaiic(device, card, by_path["semi"])
    torch.cuda.empty_cache()
    by_path.update(run_loop(device, card))
    torch.cuda.empty_cache()
    print("mean-teacher family (phase 13):")
    t0 = time.perf_counter()
    by_path.update(run_mt_loop(device, card))
    torch.cuda.empty_cache()
    by_path.update(run_mt_steps(device, card))
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    by_path.update(run_chain(device, card))
    torch.cuda.empty_cache()
    print("self-paced and superpixel InfoNCE, the resize datasets on disk (phase 14):")
    t0 = time.perf_counter()
    by_path.update(run_phase14(device, card, recs))
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    print("the simple hooks, MixUp and the cross-correlation block (phase 15):")
    t0 = time.perf_counter()
    by_path.update(run_phase15(device, card, recs))
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    print("the differentiable mean teacher, multicore and adversarial trainers (phase 16):")
    t0 = time.perf_counter()
    by_path.update(run_phase16(device, card))
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    print("the other architectures and the step and optimizer knobs (phase 17):")
    t0 = time.perf_counter()
    by_path.update(run_phase17(device, card, recs))
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    print("data parallelism: semi, its hooks and trainers, the block, MixUp, multicore, DMT "
          "and the pretrain step (phases 18-20):")
    t0 = time.perf_counter()
    by_path.update(run_dp(device, card))
    torch.cuda.empty_cache()
    print(f"phases 18-20: {time.perf_counter() - t0:.1f} s")
    print("experiment tooling and run observability: a udaiic grid and a pretrain -> ft chain "
          "through the generator, the submitter and main -p (phase 21):")
    t0 = time.perf_counter()
    by_path.update(run_phase21(device, card))
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    print("the last modules: the cluster-plot entry, E1/E2 at its batch, the monitor pass, "
          "the loader's prefetch thread and native crop (phase 22):")
    t0 = time.perf_counter()
    by_path.update(run_phase22(device, card, recs))
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    print(f"K = {P23_UNROLL} train steps a call, one CUDA graph a call, against eager steps "
          f"(phase 23):")
    t0 = time.perf_counter()
    by_path.update(run_phase23(device, card))
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    print(f"chunked evaluation, one CUDA graph a chunk of 32 eval batches, and K = "
          f"{P23_UNROLL} steps a call on {DP_WORLD} ranks (phase 24):")
    t0 = time.perf_counter()
    by_path.update(run_phase24(device, card))
    torch.cuda.empty_cache()
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    for trainer, data, warmup, timed in (
            ("pretrain_decoder", "acdc", PRETRAIN_WARMUP, PRETRAIN_TIMED),
            ("pretrain", "acdc", 1, ENCODER_STEPS - 1),
            ("pretrain_decoder", "prostate", PROSTATE_WARMUP, PROSTATE_TIMED),
            ("pretrain", "prostate", 1, PROSTATE_ENCODER_STEPS - 1)):
        path = trainer if data == "acdc" else f"{trainer}/{data}"
        by_path[path] = run_pretrain(device, card, trainer, warmup, timed, data)
        torch.cuda.empty_cache()

    out = []
    for k, r in recs.items():
        src, main_path = ROUTES[k]
        out.append(dict(name=k, route="cuda", source=f"contrastyou_tpu_torch/ops/csrc/{src}",
                        replaces=SOURCES[k], launches=by_path[main_path][k],
                        launches_by_path={p: c[k] for p, c in by_path.items()},
                        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"],
                        **{k: r[k] for k in ("device_ms", "by_batch", "by_padding", "by_anchors")
                           if k in r}))
    out[[o["name"] for o in out].index("supcon_loss")]["route_sweep"] = route
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def eval_main() -> int:
    """``python3 chip_smoke.py eval``: phase 24 alone, the kernels built
    first."""
    import torch
    from contrastyou_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    t0 = time.perf_counter()
    run_phase24(torch.device("cuda", 0), card)
    print(f"phase 24: passed in {time.perf_counter() - t0:.1f} s")
    return 0


def unroll_main(kinds) -> int:
    """``python3 chip_smoke.py unroll [kind ...]``: phase 23's check
    (``p23_path``) on each ``kind`` device-cached (default
    :data:`P23_EXTRA`), its record printed; the kernels are built first."""
    import torch
    from contrastyou_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card)
    _build.build()
    failed = []
    for kind in kinds or P23_EXTRA:
        t0 = time.perf_counter()
        try:
            r = p23_path(f"{kind}/unroll", kind, False, torch.device("cuda", 0), card)
            print(f"{kind}/unroll: passed in {time.perf_counter() - t0:.1f} s: "
                  f"{json.dumps(r['record'])}")
        except Exception as e:       # report every path, then fail
            failed.append(kind)
            print(f"{kind}/unroll: FAILED in {time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}")
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main() if len(sys.argv) == 1 else
             unroll_main(sys.argv[2:]) if sys.argv[1] == "unroll" else
             eval_main() if sys.argv[1:] == ["eval"] else 2)
