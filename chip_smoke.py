#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`openstereo_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one (or
without the repository around it). Phases, each of which fails the run:

1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the main path from `openstereo_tpu_torch/csrc`
   (one nvcc per source, in parallel), and print ptxas's registers, spills
   and shared memory for the tensor-core kernels of K4 and K2 and for the
   cost-volume kernel of K1 and K3;
3. K1 (corr_volume) against its plain version at the main-path shape, at
   CoEx's (C 48) and at FADNet's ([1,128,72,120], D 40), f32 (TF32 off) and
   bf16, plus a ragged-width and a d >= W case. f32: max-abs <= 1e-5 and,
   where C/G < 64, bit-equal everywhere (`volume_f32_check`: the kernel sums
   in the order of PyTorch's CUDA mean). The bf16 plain version takes
   the same bf16 inputs and rounds each product to bf16, as JAX does; the
   kernel must be within `bf16_close` everywhere and bit-equal at all but
   VOLUME_FLIP_SHARE of the elements (`volume_bf16_check`), and at the
   main-path, CoEx and FADNet shapes the unrounded control (products in
   f32) must fail that check;
4. K2 (fused_mbconv) against its plain version at the 14 distinct shapes of
   the LightStereo-S, CoEx, MSNet3D and MSNet2D paths, f32 (TF32 off) and
   bf16, with and without the residual where
   Cin == Cout, with the launcher's split count at each shape, and in bf16
   at forced hidden-channel split counts through the launcher itself;
5. K4 (rel_attention) against its plain version at the 3 STTR main-path
   shapes and at edge cases (W ragged against the row tile, W = 416, W = 1,
   masked with raw at a small W, W = 640 without raw, raw at its W limit,
   every supported head width), f32 (TF32 off) and bf16, and that W = 2048
   with raw is refused. The bf16 plain versions of K2 and K4 take the same
   bf16 inputs and round h, d and p to bf16 where the TPU kernels do
   (`bf16_close_flips` says how the two may differ); at the main-path
   shapes, controls that round in the wrong place (K2: h or d left in f32;
   K4: p left in f32, or exp(s - m) rounded before the division by l) must
   fail the same check;
6. the LightStereo path: LightStereo-S at 544x960, b1, bf16, random weights
   from a seed, through the port's infer entry (`tools/infer.py:run_pair`)
   on a few synthetic pairs (a random image and the same image rolled by
   12 px), with the launch counts, and the shapes the kernels were launched
   at, read around it and held against the expected ones, and the kernel
   path held against the eager path in f32 and bf16;
7. the STTR path: STTR at 540x960 (`cfgs/sttr/sttr_flyingthings3d.yaml`),
   b1, bf16, the same way, with 18 K4 launches per frame at 3 shapes; the
   kernel path against the eager path in f32 (last-layer raw attention and
   disparity) and bf16 (share of pixels within 3 px);
8. timing with CUDA events: frames/s eager vs kernels of both models (the
   `bench.py` protocol), and per kernel at each shape its path launched it
   at its time, its plain version's, a yardstick and its bound, summed per
   frame with the launch counts recorded in phases 6 and 7 (K1 also its
   device time per launch from torch.profiler beside its bound); and a
   torch.profiler pass over STTR frames of both paths (tables under
   `chiprun_out/sttr_profile/`).
9. K3 (gwc_volume) against its plain version at the GwcNet main-path shape,
   at CFNet's three (G 40: [1,160,72,120] D 24, [1,320,36,60] D 12,
   [1,320,18,30] D 6, below the kernel's 8-disparity chunk), at IGEV's two
   (C/G 12, the bf16 quotient's refined division: [1,96,136,240] and the
   KITTI evaluation's [4,96,96,312], D 48, G 8), at IGEV++'s ([1,96,136,240]
   D 192 G 8) and at edge
   cases (the JAX test's shape, W ragged against the 8-column chunks, D over
   six disparity chunks, d >= W, cg = 1, cg = 12), f32 (TF32 off) and bf16
   (checked as K1's, with the unrounded control at the GwcNet, CFNet and
   IGEV shapes), and with G = 1 against K1; then with divisor 1 (the sum) on
   group-normalised features against the plain cosine builder
   (`ops.build_cosine_gwc_volume`) at FoundationStereo's and
   FastFoundationStereo's [1,224,136,240] G 8, D 104 and 48: f32 bit-equal,
   bf16 as K1's, the unrounded control rejected (`cosine_k3_check`);
10. the GwcNet path: GwcNet at 544x960 (`cfgs/gwcnet/gwcnet_sceneflow.yaml`),
   b1, bf16, through `run_pair` on the synthetic pairs, with 1 K3 launch
   per frame at the main shape and no other kernel; the kernel path against
   the eager path in f32 (max-abs) and bf16 (mean-abs);
11. the PSMNet path: PSMNet at 544x960 (`cfgs/psmnet/psmnet_sceneflow.yaml`),
   b1, bf16, through `run_pair`; no kernel of the port lies on it, and the
   phase checks that none launched;
12. timing: GwcNet frames/s eager vs kernels, PSMNet frames/s, K3 at the
   main shape beside its plain version and its bound (CUDA events and its
   device time per launch from torch.profiler), and torch.profiler
   passes over GwcNet frames of both paths and over PSMNet frames (tables
   in `gwcnet_profile/` and `psmnet_profile/` beside STTR's).

13. K1 and K2 at the trainer's evaluation batch (12 pairs at 544x960: K1
   [12,24,136,240] and K2 at batch 24 in the trunk and 12 in the
   aggregation), f32 (TF32 off) and bf16, with the checks of phases 3 and 4
   and the launcher's split count printed for each shape;
14. training: a synthetic SceneFlow-layout set (96 + 12 random-dot pairs at
   540x960, PNG and PFM, under `chiprun_out/train_smoke/`), and the port's
   training entry point (`openstereo_tpu_torch/tools/train.py`) on
   `cfgs/lightstereo/lightstereo_s_sceneflow.yaml` pointed at it, with
   NUM_EPOCHS cut to 1 (4 steps of 24 at 320x736, bf16, AdamW, OneCycleLR,
   clip by value). Finite losses; its evaluation launches K1 once and K2 18
   times per batch of 12 and nothing else is launched in the run; its EPE
   within 0.5 px of an eager evaluation of the same weights; a resumed
   Trainer starts at epoch 1, bit-equal to the checkpoint. Prints ms per
   step (CUDA events, median of steps 2-4), samples/s, peak memory;
15. the learning check: the port's `tools/overfit_check.py`, LightStereo,
   40 steps (cut from 150, then 100, then 60, for the script's time) on one batch of 4
   random-dot pairs at 192x384, max_disp 64, bf16, AdamW 4e-4, clip 0.1: the
   final train EPE must be below 3 px.
16-18. (run after phase 12) the CoEx, MSNet3D and MSNet2D paths, each at
   544x960 (`cfgs/coex/coex_sceneflow_amp.yaml`, `cfgs/msnet/msnet3d_sceneflow.yaml`,
   `cfgs/msnet/msnet2d_sceneflow.yaml`), b1, bf16, random weights from a
   seed, through `run_pair` on the synthetic pairs: the launch records per
   frame by shape (CoEx K1 1 at C 48 and K2 11; MSNet3D K3 1 and K2 2;
   MSNet2D K2 18; no other kernel), peak memory, the kernel path against
   the eager path in f32 with TF32 off (MSNets max-abs <= 5e-3 px; CoEx,
   whose top-k may flip on a near-tie, >= 99.9 % of pixels within 5e-3 px)
   and bf16 (MSNets mean-abs <= 0.5 px; CoEx the cost feeding its top-2
   head within 2^-7 of its largest magnitude on average, and the kernel
   path's disparity no more than 5 % further from the f32 one than the
   eager path's); frames/s of both paths (2 groups each, with their spread
   and the host's time to issue a frame), a torch.profiler pass over 3
   frames of the kernel path (table in `chiprun_out/<model>_profile/`), and
   each kernel at the path's shapes beside its plain version and bound.
   (Before phases 46-47 were added: 4 groups, 5-10 profiled frames of both
   paths and the f32 check on every pair; cut for the script's time.)
19-22. (run after phase 18) the CFNet, FADNet, CasGwcNet and CasPSMNet paths
   in the same way, each at its config's EVALUATING size
   (`cfgs/cfnet/cfnet_sceneflow.yaml` and `cfgs/fadnet/fadnet_sceneflow.yaml`
   576x960, `cfgs/casnet/casnet_gwc_sceneflow.yaml` and
   `casnet_psm_sceneflow.yaml` 544x960): CFNet launches K3 3 times a frame at
   its three shapes, FADNet K1 once, the cascades no kernel. f32 kernel vs
   eager: max-abs <= 5e-3 px, but CFNet >= 99.9 % of the pixels within 5e-3
   px (its sample grids are floors, which two K3 sum orders may move by one
   disparity at a pixel); bf16 mean-abs <= 0.5 px.
23. (run after phase 15) K4 under autograd (`ops/rel_attention.py:
   rel_attention_trainable`: K4's forward, the PyTorch backward) at STTR's
   three training shapes (W' 213 of the 360x640 crop; 240 and 120 lines),
   f32 with TF32 off, against autograd through the plain version: out, raw
   and the five input gradients for random cotangents, within 2e-4 +
   1e-4·|ref| (the JAX package's gradient test); a control whose `_unskew`
   is shifted by one column must fail that check. Prints each gradient's
   error against the exact (f64) gradient beside the plain version's, and
   times K4's forward, the backward, both paths' forward + backward and
   their bounds at f32 rates;
24. STTR training: a synthetic FlyingThings3D-subset set (8 + 4 random-dot
   pairs at 540x960: PNG views, left and right PFM disparities, occlusion
   PNGs derived from them, under `chiprun_out/sttr_train_smoke/`, deleted
   afterwards), `cfgs/sttr/sttr_flyingthings3d.yaml` through
   `tools/train.py` with NUM_EPOCHS 1 (8 steps at b1 360x640, f32, RMSprop,
   clip 35): finite losses; K4 18 times a train step at the three training
   shapes and 18 times an evaluation frame at W 320, nothing else; one step
   of the same weights and batch, 12 runs with kernels and 12 eager: the
   loss terms within 1e-5 relative, and each parameter's gradient no
   further from the same step in f64 in the kernel runs' median than 2x the
   eager runs' worst error + 1e-4·max|g| of the tensor + 1e-6·max|g| of the
   model
   (f32 itself puts the eager gradients of the full-resolution convs
   ~1e-2·max|g| from f64, and one run's error jumps between levels from run
   to run: `compare_step_grads`), every run regressing the f64 step's argmax
   windows (`pinned_windows`), and a control with K4's `_unskew` shifted
   must fail that gradient check; the evaluation's
   EPE within 0.5 px of an eager evaluation; a resumed Trainer bit-equal to
   the checkpoint, RMSprop's nu included; ms/step (CUDA events, median of
   the steps after the first), samples/s, the backward's share, peak memory,
   device busy and idle share of both paths;
25. STTR's learning check: the port's `tools/overfit_check.py --model STTR`,
   40 steps (cut from 100, then 60, for the script's time) on one batch of 2
   random-dot pairs at 192x384, f32, RMSprop
   1e-4 constant, clip by norm 35: the mean loss of the last 20 steps must
   fall below 0.8 of the first 5 steps'.
26-30. (run after phase 25) training of GwcNet, PSMNet, CoEx, MSNet3D and
   MSNet2D: first K1, K2 and K3 at the shapes their trainer evaluations
   launch them at (batch 2 at 544x960: K3 [2,320,136,240] D 48 G 40, K1
   [2,48,136,240] D 48, K2 at 4 in the siamese trunks and 2 after), with the
   checks of phases 3, 4 and 9; then, on a synthetic SceneFlow-layout set
   (32 + 4 random-dot pairs at 540x960 under `chiprun_out/zoo_train_smoke/`,
   deleted afterwards), each model's config (`cfgs/gwcnet/gwcnet_sceneflow.yaml`,
   `cfgs/psmnet/psmnet_sceneflow.yaml`, `cfgs/coex/coex_sceneflow_amp.yaml`,
   `cfgs/msnet/msnet3d_sceneflow.yaml`, `cfgs/msnet/msnet2d_sceneflow.yaml`)
   through `tools/train.py` at its 256x512 crop, batch (4, 4, 8, 1, 4),
   dtype (CoEx bf16, the rest f32 with TF32 off), optimizer, schedule and
   clip, cut to NUM_EPOCHS 1 of 4 steps and an evaluation of 4 pairs at
   544x960, batch 2. Each asserts finite losses; no launch in training and,
   per evaluation batch, GwcNet K3 1, MSNet3D K3 1 and K2 2, MSNet2D K2 18,
   CoEx K1 1 and K2 11, PSMNet none, at the expected shapes; the evaluation
   with kernels against the same weights eager, both under cuDNN's
   deterministic algorithms (f32 max-abs <= 5e-3 px; CoEx phase 16's rule);
   for GwcNet a resumed Trainer bit-equal to the checkpoint. Each prints ms/step (median of steps 2-4), samples/s, peak
   memory, forward / backward / optimizer ms, device busy and idle share
   over 1 profiled step (cut from 2 for the script's time) and, for GwcNet
   and PSMNet, the peak with
   MODEL.REMAT and, for an f32 config, the second of 2 steps with TF32 off
   (cut from 4 for the script's time). Each then checks one step at b1 128x256 in f32 (TF32 off)
   against the same step in f64 on the card (`zoo_grad_check`), where a
   control that detaches the features before the volume must fail; and
   last GwcNet's learning check (`tools/overfit_check.py --model GwcNet`,
   40 steps (cut from 200, then 100, then 60, for the script's time) at 192x384, b2, f32,
   RMSprop 1e-4, clip 35: the mean loss of the last 20 steps below 0.8 of
   the first 5 steps').
31-34. (run after phase 30, in the same loop) training of CFNet, CasGwcNet,
   CasPSMNet and FADNet: first, with phases 26-30's kernel checks, K3 at
   CFNet's three evaluation shapes (batch 1), K1 at FADNet's [10,128,72,120]
   D 40 (f32) and at CoEx's config's evaluation batch, [10,48,136,240] D 48
   (bf16), both also timed (CUDA events, device ms, plain version, bound at
   their type's rates); then each main SceneFlow config as written
   (`cfgs/cfnet/cfnet_sceneflow.yaml`, `cfgs/casnet/casnet_gwc_sceneflow.yaml`,
   `cfgs/casnet/casnet_psm_sceneflow.yaml`, `cfgs/fadnet/fadnet_sceneflow.yaml`:
   crops 256x512, 256x512, 256x512, 384x768, batch 4, 4, 4, 1, f32 with cuDNN
   TF32, RMSprop or Lamb, MultiStepLR with warm-up) through `tools/train.py`
   for 4 steps, evaluated at the config's own EVALUATOR.BATCH_SIZE_PER_GPU
   and pad (CFNet 2 pairs at b1, 576x960; the cascades 10 at b10, 544x960;
   FADNet 10 at b10, 576x960; 32 + 10 pairs written). No launch in training;
   per evaluation batch CFNet K3 3 at its three shapes, FADNet K1 1 at
   [10,128,72,120], the cascades none; the evaluation against eager as in
   phases 26-30 (CFNet f32 >= 99.9 % of the pixels within 5e-3 px, FADNet max-abs <= 5e-3 px, the
   cascades finite); ms/step, the forward / backward / optimizer split, peak
   memory, 1 profiled step; the gradient check as phases 26-30 with each
   model's bound (`ZOO_NEW_BOUNDS`) and a detach control on its volume
   builders. Left out against phases 26-30, for the script's time: the
   TF32-off timing, MODEL.REMAT and the resume check.
35. FADNet's learning check through Lamb (`tools/overfit_check.py --model
   FADNet`, 40 steps (cut from 100, then 60, for the script's time) of b1 at 192x384,
   f32, Lamb 4e-3 constant): the mean
   loss of the last 20 steps below 0.8 of the first 5 steps'.
36. (run after phase 22) the IGEV-Stereo path (`cfgs/igev/igev_sceneflow_amp.yaml`,
   full width: hidden dims 128, 3 GRU layers slow-fast, 2 correlation
   levels, radius 4, 32 iterations) at 544x960, b1, bf16, as phases 16-22
   run theirs (`igev_path`): K3 once a frame at [1,96,136,240] D 48 G 8 and
   K2 11 times at CoEx's trunk shapes, nothing else; f32 (TF32 off) kernels
   vs eager, both under cuDNN's deterministic algorithms, >= 99.9 % of the
   pixels within 5e-3 px (the max-abs printed: 32 GRU iterations carry a
   one-ulp difference forward), bf16 mean-abs <= 0.5 px; frames/s, profile,
   peak memory, each kernel at its shapes beside its plain version and
   bound; then the measure CLI (`tools/measure.py`: parameters, FLOPs,
   ms/frame beside the card's name and power limit).
37. the evaluation CLI (`tools/eval.py --cfg_file cfgs/igev/igev_sceneflow_amp.yaml
   --eval_data_cfg_file <cfgs/kitti15_eval.yaml, its split pointed at the set>
   --data_paths <the set>`) on 8 random-dot pairs written at 375x1242 in the
   KITTI 2015 layout (image_2, image_3 PNG, disp_occ_0 uint16 PNG x256) under
   `OUT_DIR / "kitti_eval_smoke"` and deleted afterwards: padded to
   384x1248 with NormalizeImage, batch 4, bf16; per batch K3 once at
   [4,96,96,312] and K2 11 times at batch 8 and nothing else; the same
   Trainer eager; d1_all, epe and thres_1..3 of both printed, |d epe| <= 0.5
   px and the others <= 2 percentage points. First K2 at those batch-8
   shapes against its plain version (phase 4's checks) and K2 and K3 timed
   there beside their bounds.
38-40. (run after phase 37) the IGEV-RT, StereoBase and IGEV++ paths
   (`cfgs/igev_rt/igev_rt_sceneflow_amp.yaml`, `cfgs/stereobase/stereobase_sceneflow.yaml`,
   `cfgs/igevpp/igevpp_sceneflow_amp.yaml`, full width and depth: 8, 32 and
   32 GRU iterations) at 544x960, b1, bf16, as phase 36 runs IGEV's
   (`igev_family_paths`): K2 11 times a frame at CoEx's trunk shapes and K3
   once, at [1,96,136,240] D 48 G 8 (IGEV-RT, StereoBase) or D 192
   (IGEV++), nothing else; f32 kernels vs eager >= 99.9 % of the pixels
   within 5e-3 px (max-abs printed), bf16 mean-abs <= 0.5 px; frames/s,
   profile, peak memory, each kernel at its shapes beside its plain version
   and bound; then, for IGEV++, the measure CLI with 5 timed frames.

41-44. (in phases 26-34's loop) training of IGEV, IGEV-RT, StereoBase and
   IGEV++ (`igev_family_train_paths`): first, with phases 26-34's kernel
   checks, K3 at their trainer evaluations' shapes ([10,96,136,240] D 48 for
   IGEV, [8,...] for IGEV-RT, [4,...] for StereoBase, [4,96,136,240] D 192
   for IGEV++, all G 8) and K2 at CoEx's trunk shapes at batch 20, 16 and 8,
   each also timed beside its bound (`trainer_eval_timing`); then each
   SceneFlow config as written (`cfgs/igev/igev_sceneflow_amp.yaml` 320x736
   b4 with MODEL.REMAT, `cfgs/igev_rt/igev_rt_sceneflow_amp.yaml` 320x768 b1,
   `cfgs/stereobase/stereobase_sceneflow.yaml` 320x736 b2,
   `cfgs/igevpp/igevpp_sceneflow_amp.yaml` 256x768 b1; bf16, AdamW, each
   its schedule and clip, FREEZE_BN, 22 GRU iterations) through
   `tools/train.py` for 4 steps, evaluated in one batch at its config's
   EVALUATOR batch (10, 8, 4, 4) at 544x960: K3 once and K2 11 times a
   batch, nothing in training; kernels vs eager by the rule "share_f32" (f32
   at the same batch through PyTorch's own convolutions >= 99.9 % of the
   pixels within 5e-3 px, bf16 mean-abs <= 0.31 px);
   ms/step, the forward / backward / optimizer split, peak memory, 1
   profiled step (idle share); the gradient check at 128x256 (IGEV++
   128x768) with the bounds of `IGEV_FAMILY_BOUNDS`, whose control, the GRU
   loop without its per-iteration detach, must fail it.
45. IGEV's learning check (`tools/overfit_check.py --model IGEV`, 40 steps of
   b2 at 192x384, bf16, AdamW 2e-4 constant, clip by norm 35; 60 in a first
   run, cut for the script's time: loss ratio 0.185): the mean loss of the
   last 20 steps below 0.8 of the first 5 steps'.
46-47. (run after phase 40) the FoundationStereo and FastFoundationStereo
   paths (`foundationstereo_paths`: `cfgs/foundationstereo/fstereo_foundationstereo.yaml`,
   vitl, D/4 104, 32 iterations of the three-scale selective GRU, 371.7M
   parameters; `cfgs/fast_foundationstereo/ffstereo_sceneflow.yaml`, 8
   iterations of one scale) at 544x960, b1, bf16, as phases 36-40 run theirs:
   the synthetic pairs through the TRAINING list's NormalizeImage where the
   config has no EVALUATING list (`eval_transforms`); K3 once a frame with
   divisor 1 at [1,224,136,240] D 104 and D 48 (the cosine volume), nothing
   else; f32 kernels vs eager max-abs <= 5e-3 px under cuDNN's deterministic
   algorithms, bf16 mean-abs <= 0.5 px; parameters, peak memory, frames/s,
   profile (device busy, idle share), K3's device time beside its bound; then,
   for FoundationStereo, the measure CLI with FS_MEASURE_REPS timed frames.
48. (run after phase 47) the MonSter path (`monster_path`:
   `cfgs/monster/monster_sceneflow.yaml`, full width and depth: the frozen
   DepthAnythingV2 ViT-S and DPT depth head, the DPT pyramid decoder, 25
   IGEV GRU iterations and 7 mutual-refinement iterations, REMP) at 544x960,
   b1, bf16, its EVALUATING transforms (DivisiblePad 32,
   NormalizeToMinusOneOne), as phases 46-47 run theirs: K3 once a frame at
   [1,96,136,240] D 48 G 8 (IGEV's shape, checked in phase 9), nothing else;
   f32 kernels vs eager max-abs <= 5e-3 px under cuDNN's deterministic
   algorithms, bf16 mean-abs <= 0.5 px; parameters, peak memory, frames/s
   (2 groups of 2 frames), profile of 1 frame (device busy, idle share),
   K3's device time beside its bound. No measure CLI.
49-51. (in phases 26-34's loop, after 44) training of FoundationStereo,
   FastFoundationStereo and MonSter (`fs_family_train_paths`): first, with
   phases 26-34's kernel checks, K3 at their trainer evaluations' shapes:
   FoundationStereo vits [1,128,136,240] D 48 G 8 divisor 1 (the cosine
   volume, C/G 16: f32 bit-equal to the plain cosine builder, bf16
   `volume_bf16_check` and its unrounded control, `cosine_k3_check`),
   FastFoundationStereo [1,224,136,240] D 48 divisor 1, MonSter
   [8,96,136,240] D 48 G 8, each also timed beside its bound
   (`trainer_eval_timing`); then each SceneFlow config as written
   (`cfgs/foundationstereo/fstereo_sceneflow.yaml` vits 320x736 b2,
   `cfgs/fast_foundationstereo/ffstereo_sceneflow.yaml` 320x736 b2 with 12
   iterations of one GRU scale, `cfgs/monster/monster_sceneflow.yaml` 320x736
   b3 with its colour, erase and scale transforms, 15 IGEV and 7 mutual
   iterations and FREEZE_BN; bf16, AdamW, OneCycleLR, clip by norm 1) through
   `tools/train.py` for 4 steps, evaluated in one batch at its config's
   EVALUATOR batch (1, 1, 8) at 544x960 (RightTopPad; MonSter's DivisiblePad
   32 of the 540x960 pairs): K3 once a batch, nothing in training; kernels
   vs eager by the rule "share_f32" (FoundationStereo's and
   FastFoundationStereo's f32 passes at b1 under cuDNN's deterministic
   algorithms, MonSter's at b8 through PyTorch's own convolutions); ms/step,
   the split, peak memory, 1 profiled step; the gradient check at 128x256
   with `FS_FAMILY_BOUNDS`, whose control, the GRU loops without their
   detach (`carried` in each model's module), must fail it.
52. FastFoundationStereo's learning check (`tools/overfit_check.py --model
   FastFoundationStereo`, 40 steps of b1 at 192x384, bf16, AdamW 2e-4
   constant, clip by norm 1, 12 GRU iterations): the mean loss of the last 20
   steps below 0.8 of the first 5 steps'.

Each phase prints its seconds on a `[phase-time]` line as it ends, and all
of them once more before the JSON lines.

The line before the card line is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.
"""

import copy
import importlib
import json
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

H, W = 544, 960
N_PAIRS = 3
# pairs of the f32 kernel-vs-eager check of phases 16-22, 36-40 and 46-48 (all N_PAIRS before phases
# 46-47 were added; cut for the script's time)
F32_PAIRS = 1
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"  # git-ignored: profiler tables
CFG_FILE = ROOT / "cfgs/lightstereo/lightstereo_s_sceneflow.yaml"
STTR_CFG = ROOT / "cfgs/sttr/sttr_flyingthings3d.yaml"
STTR_HW = (540, 960)
GWC_CFG = ROOT / "cfgs/gwcnet/gwcnet_sceneflow.yaml"
PSM_CFG = ROOT / "cfgs/psmnet/psmnet_sceneflow.yaml"
COEX_CFG = ROOT / "cfgs/coex/coex_sceneflow_amp.yaml"
MSNET3D_CFG = ROOT / "cfgs/msnet/msnet3d_sceneflow.yaml"
MSNET2D_CFG = ROOT / "cfgs/msnet/msnet2d_sceneflow.yaml"
CFNET_CFG = ROOT / "cfgs/cfnet/cfnet_sceneflow.yaml"
FADNET_CFG = ROOT / "cfgs/fadnet/fadnet_sceneflow.yaml"
CASGWC_CFG = ROOT / "cfgs/casnet/casnet_gwc_sceneflow.yaml"
CASPSM_CFG = ROOT / "cfgs/casnet/casnet_psm_sceneflow.yaml"
IGEV_CFG = ROOT / "cfgs/igev/igev_sceneflow_amp.yaml"
IGEV_RT_CFG = ROOT / "cfgs/igev_rt/igev_rt_sceneflow_amp.yaml"
STEREOBASE_CFG = ROOT / "cfgs/stereobase/stereobase_sceneflow.yaml"
IGEVPP_CFG = ROOT / "cfgs/igevpp/igevpp_sceneflow_amp.yaml"
FS_CFG = ROOT / "cfgs/foundationstereo/fstereo_foundationstereo.yaml"
FFS_CFG = ROOT / "cfgs/fast_foundationstereo/ffstereo_sceneflow.yaml"
MONSTER_CFG = ROOT / "cfgs/monster/monster_sceneflow.yaml"
KITTI_EVAL_CFG = ROOT / "cfgs/kitti15_eval.yaml"

# expected K2 launches per LightStereo-S frame: (batch, H, W, Cin, Ch, Cout, residual) → count
K2_SHAPES = {
    (2, 136, 240, 24, 144, 24, True): 1,
    (2, 68, 120, 32, 192, 32, True): 2,
    (2, 34, 60, 64, 384, 64, True): 3,
    (2, 34, 60, 64, 384, 96, False): 1,
    (2, 34, 60, 96, 576, 96, True): 2,
    (2, 17, 30, 160, 960, 160, True): 2,
    (1, 136, 240, 48, 192, 48, True): 2,
    (1, 68, 120, 96, 384, 96, True): 2,
    (1, 34, 60, 192, 768, 192, True): 3,
}
# expected K2 launches per frame of the CoEx, MSNet3D and MSNet2D paths at 544x960: CoEx's
# trunk is LightStereo-S's (batch 2, 11 launches); MSNet's trunk stem (2 launches) and,
# in MSNet2D, the 2D volume's blocks (dres 4, the hourglasses' conv2 and redir2 6,
# conv4 3, redir1 3)
COEX_K2_SHAPES = {k: n for k, n in K2_SHAPES.items() if k[0] == 2}
MSNET3D_K2_SHAPES = {(2, 272, 480, 32, 96, 32, True): 2}
MSNET2D_K2_SHAPES = {
    (2, 272, 480, 32, 96, 32, True): 2,
    (1, 136, 240, 48, 144, 48, True): 4,
    (1, 68, 120, 96, 192, 96, True): 6,
    (1, 34, 60, 192, 384, 192, True): 3,
    (1, 136, 240, 48, 96, 48, True): 3,
}
K2_ALL_SHAPES = sorted(set(K2_SHAPES) | set(COEX_K2_SHAPES) | set(MSNET3D_K2_SHAPES)
                       | set(MSNET2D_K2_SHAPES), reverse=True)
# the launcher's hidden-channel split count at each main-path shape (B, H, W, Ch) on a
# card with 132 SMs (H100 SXM); tests/test_torch_kernel_plans.py walks the same rule
K2_SPLITS_132 = {(2, 136, 240, 144): 1, (2, 68, 120, 192): 2, (2, 34, 60, 384): 6,
                 (2, 34, 60, 576): 6, (2, 17, 30, 960): 15, (1, 136, 240, 192): 2,
                 (1, 68, 120, 384): 4, (1, 34, 60, 768): 12,
                 # MSNet3D and MSNet2D
                 (2, 272, 480, 96): 1, (1, 136, 240, 144): 2, (1, 68, 120, 192): 3,
                 (1, 34, 60, 384): 12, (1, 136, 240, 96): 2}
K1_SHAPE = (1, 24, 136, 240, 48)  # B, C, H/4, W/4, D
COEX_K1_SHAPE = (1, 48, 136, 240, 48)  # CoEx's cosine volume: 48 descriptor channels
# K2 at forced split counts, through the launcher itself: (shape as K2_SHAPES,
# residual, splits)
K2_SPLIT_CASES = [
    ((1, 9, 21, 24, 80, 24, True), True, (1, 2, 3)),
    ((2, 17, 30, 160, 960, 160, True), True, (1, 30)),
]

# expected K4 launches per STTR frame: (lines, W', E, nheads, masked, need_raw) → count.
# 6 self layers on left+right (2·180 lines), 12 cross calls on 180 lines, the
# last of them masked and with the raw attention
K4_SHAPES = {
    (360, 320, 128, 8, False, False): 6,
    (180, 320, 128, 8, False, False): 11,
    (180, 320, 128, 8, True, True): 1,
}
# K4 edge cases: (B, W, E, nheads, masked, need_raw, what)
K4_EDGES = [
    (4, 37, 64, 2, True, True, "W ragged against the 32-row tile, hd 32"),
    (2, 416, 128, 2, False, True, "W of a 1248-wide frame, hd 64"),
    (3, 1, 32, 4, True, True, "W = 1, hd 8"),
    (2, 50, 128, 8, True, True, "masked with raw, small W"),
    (2, 640, 128, 8, False, False, "W of a 1920-wide frame, no raw"),
    (1, 448, 128, 2, True, True, "masked with raw at the bf16 raw tile's limit, hd 64"),
]

K3_SHAPE = (1, 320, 136, 240, 48, 40)  # B, C, H/4, W/4, D, G of GwcNet at 544x960
# CFNet at 576x960: K3 at 1/8, 1/16 and 1/32 (D = 192/8, /16, /32), once each a frame
CFNET_K3_SHAPES = {(1, 160, 72, 120, 24, 40): 1, (1, 320, 36, 60, 12, 40): 1,
                   (1, 320, 18, 30, 6, 40): 1}
FADNET_K1_SHAPE = (1, 128, 72, 120, 40)  # FADNet at 576x960: 1/8, D = 192/8 + 16
# f32 K1/K3 equal the plain version bit for bit where a group has fewer channels than this
# (`csrc/cost_volume.cu`); from 64 on PyTorch's CUDA mean splits a sum over warps
F32_EXACT_CG = 64
# K3 edge cases: ((B, C, H, W, D, G), what)
K3_EDGES = [
    ((1, 16, 4, 260, 12, 4), "the JAX test's shape"),
    ((1, 32, 3, 37, 12, 4), "W ragged against the 8-column chunks"),
    ((2, 64, 3, 130, 100, 8), "D = 100, 13 disparity chunks"),
    ((1, 8, 2, 6, 10, 2), "d >= W"),
    ((1, 16, 3, 50, 20, 16), "cg = 1"),
    ((1, 96, 5, 70, 24, 8), "cg = 12 (C 96, G 8)"),
]

# IGEV-Stereo (phases 36-37) and MonSter (phase 48): K3 at its group width C/G = 12 (96
# descriptor channels, G 8, D 192/4), at the SceneFlow config's 544x960 b1 and at the KITTI
# evaluation's 384x1248 b4 (`cfgs/kitti15_eval.yaml`: RightTopPad,
# EVALUATOR.BATCH_SIZE_PER_GPU 4); IGEV's MobileNetV2 trunk is CoEx's, both views in one batch:
# K2 11 a frame, at batch 2 (COEX_K2_SHAPES) and at batch 8 in the evaluation
IGEV_K3_SHAPE = (1, 96, 136, 240, 48, 8)
# IGEV++ (phase 40): one K3 volume over all MAX_DISP/4 = 192 planes (768 / 4), 24 of the
# kernel's 8-plane chunks, from which its three ranges are carved
IGEVPP_K3_SHAPE = (1, 96, 136, 240, 192, 8)
# FoundationStereo and FastFoundationStereo (phases 46-47): K3 with divisor 1, the cosine volume's
# sum over the group-normalised 1/4 features (C 224 = 96 + 128 at the vitl budget, G 8, C/G 28),
# D 416/4 and 192/4; the wrapper records a launch under its shape with the divisor appended
FS_K3_SHAPE = (1, 224, 136, 240, 104, 8, 1)
FFS_K3_SHAPE = (1, 224, 136, 240, 48, 8, 1)
FS_MEASURE_REPS = 3  # the measure CLI's timed frames on FoundationStereo (phase 46)
FS_SF_CFG = ROOT / "cfgs/foundationstereo/fstereo_sceneflow.yaml"
IGEV_EVAL_BATCH, IGEV_EVAL_PAIRS, KITTI_HW = 4, 8, (375, 1242)
IGEV_EVAL_K3_SHAPE = (IGEV_EVAL_BATCH, 96, 96, 312, 48, 8)
IGEV_EVAL_K2_SHAPES = {
    (8, 96, 312, 24, 144, 24, True): 1,
    (8, 48, 156, 32, 192, 32, True): 2,
    (8, 24, 78, 64, 384, 64, True): 3,
    (8, 24, 78, 64, 384, 96, False): 1,
    (8, 24, 78, 96, 576, 96, True): 2,
    (8, 12, 39, 160, 960, 160, True): 2,
}
IGEV_EVAL_DIR = OUT_DIR / "kitti_eval_smoke"
# the evaluation CLI with kernels against eager (bf16): the model phase's bf16 rule carried to
# the metrics: |d epe| <= 0.5 px, |d d1_all| and |d thres_*| <= 2 percentage points
IGEV_EVAL_TOL = {"epe": 0.5, "d1_all": 2.0, "thres_1": 2.0, "thres_2": 2.0, "thres_3": 2.0}

# The trainer's evaluation batch (EVALUATOR.BATCH_SIZE_PER_GPU of the LightStereo-S config):
# K1 at [12, 24, 136, 240] and K2 at batch 24 in the siamese trunk, 12 in the aggregation
EVAL_BATCH = 12
K1_EVAL_SHAPE = (EVAL_BATCH,) + K1_SHAPE[1:]
K2_EVAL_SHAPES = {(s[0] * EVAL_BATCH,) + s[1:]: n for s, n in K2_SHAPES.items()}
# the training phase: a synthetic SceneFlow-layout set written by this script
TRAIN_PAIRS, EVAL_PAIRS, PAIR_HW = 96, 12, (540, 960)
TRAIN_DIR = OUT_DIR / "train_smoke"
SET_DIR = OUT_DIR / "sceneflow_set"  # `sceneflow_set`: phases 14 and 26-51 read it
OVERFIT_ARGS = ["--steps", "40", "--batch", "4", "--size", "192", "384", "--max_disp", "64",
                "--lr", "4e-4", "--device", "cuda"]

# The bf16 K2 and K4 checks (`bf16_close_flips`): the share of output elements that
# may miss `bf16_close`, each within its flip allowance. Set between what a correct
# kernel reads at the main-path shapes and what the misrounded controls read there
# (PERF.md, agreement): K2 at most 5.1e-5 against >= 3.9e-2, K4 at most 2.7e-7
# against >= 3.6e-6.
K2_FLIP_SHARE, K4_FLIP_SHARE = 1e-4, 1e-6
# The bf16 K1 and K3 checks (`volume_bf16_check`): the share of elements that may
# differ from the plain version's bits (two f32 sum orders of the bf16 products may
# round the mean to two neighbours); every element stays within `bf16_close`
VOLUME_FLIP_SHARE = 1e-4
# a K1/K3 check's figures: f32 max-abs, bf16 max-abs, bf16 share not bit-equal
VOLUME_ERR_KEYS = ("max_abs_err_f32", "max_abs_err", "not_bit_equal_share")

# STTR training (phases 23-25). K4 launches per train step at the config's 360x640 crop
# (H' 120, W' 213): 6 self layers on left+right (240 lines), 12 cross calls on 120 lines,
# the last masked and with the raw attention; its evaluation at 540x960 launches K4_SHAPES
K4_TRAIN_SHAPES = {
    (240, 213, 128, 8, False, False): 6,
    (120, 213, 128, 8, False, False): 11,
    (120, 213, 128, 8, True, True): 1,
}
STTR_TRAIN_PAIRS, STTR_EVAL_PAIRS, STTR_PAIR_MAX_DISP = 8, 4, 192
STTR_TRAIN_DIR = OUT_DIR / "sttr_train_smoke"
STTR_GRAD_RUNS = 12  # f32 steps of each path in phase 24's gradient check
STTR_OVERFIT_ARGS = ["--model", "STTR", "--steps", "40", "--batch", "2", "--size", "192", "384",
                     "--max_disp", "64", "--lr", "1e-4", "--device", "cuda"]

# Training of GwcNet, PSMNet, CoEx, MSNet3D and MSNet2D (phases 26-30): each SceneFlow config
# at its 256x512 crop and batch through `tools/train.py` for 4 steps, then the trainer's
# evaluation of 4 pairs at 544x960, batch 2, through the kernels
ZOO_TRAIN_DIR = OUT_DIR / "zoo_train_smoke"
ZOO_STEPS, ZOO_EVAL_PAIRS, ZOO_EVAL_BATCH, ZOO_TRAIN_PAIRS = 4, 4, 2, 32
# the gradient check: one step at batch 1 and this crop, f32 (TF32 off) against f64; each
# tensor's gradient within its model's bound (`zoo_train_paths`) of its largest magnitude +
# ZOO_GRAD_FLOOR of the model's largest gradient
ZOO_GRAD_HW = (128, 256)
ZOO_GRAD_FLOOR = 1e-3
# the bounds of phases 31-34, relative to each tensor's largest magnitude: the smallest rel at
# which every tensor's bound (with ZOO_GRAD_FLOOR) is at least twice its worst f32 error over 3
# runs on the card, rounded up to the next 0.01 (`zoo_train_paths` says why)
ZOO_NEW_BOUNDS = {"CFNet": 0.01, "CasGwcNet": 0.25, "CasPSMNet": 0.07, "FADNet": 0.02}
# Training of IGEV, IGEV-RT, StereoBase and IGEV++ (phases 41-44, in phases 26-34's loop): each
# SceneFlow config as written through `tools/train.py` for 4 steps (22 GRU iterations, bf16),
# the trainer's evaluation of one batch at the config's EVALUATOR.BATCH_SIZE_PER_GPU and 544x960
# pad, through K3 once and K2 11 times a batch; the gradient check at ZOO_GRAD_HW (IGEV++ at
# 128x768: its 192 planes at 1/4 within the frame) with the GRU loop's detach as the control
IGEV_FAMILY_EVAL_BATCH = {"IGEV": 10, "IGEV-RT": 8, "StereoBase": 4, "IGEV++": 4}
# their gradient bounds, relative to each tensor's largest magnitude: as ZOO_NEW_BOUNDS
# (`igev_family_train_paths` says what they hold)
IGEV_FAMILY_BOUNDS = {"IGEV": 0.39, "IGEV-RT": 0.01, "StereoBase": 0.05, "IGEV++": 0.01}
# the bf16 evaluation's kernels-vs-eager mean-abs bound (px): twice the largest of 3 runs of
# phases 41-44 on the card (IGEV 0.1522-0.1547; IGEV-RT 0.0459, StereoBase 0.1071-0.1099, IGEV++
# 0.0569-0.0594), rounded up
IGEV_FAMILY_BF16_MEAN_ABS = 0.31
IGEV_OVERFIT_ARGS = ["--model", "IGEV", "--steps", "40", "--batch", "2", "--size", "192", "384",
                     "--max_disp", "64", "--lr", "2e-4", "--device", "cuda"]
ZOO_OVERFIT_ARGS = ["--model", "GwcNet", "--steps", "40", "--batch", "2", "--size", "192", "384",
                    "--max_disp", "64", "--lr", "1e-4", "--device", "cuda"]
# Training of CFNet, CasGwcNet, CasPSMNet and FADNet (phases 31-35): each main SceneFlow config
# as written through `tools/train.py` for 4 steps, the trainer's evaluation at the config's own
# EVALUATOR.BATCH_SIZE_PER_GPU and pad (CFNet 2 pairs at b1, 576x960; the cascades and FADNet
# 10 pairs at b10, 544x960 and 576x960). They read the first ZOO_TRAIN_PAIRS + ZOO_CFG_EVAL_PAIRS
# pairs of `sceneflow_set`; phases 26-30 evaluate the first ZOO_EVAL_PAIRS of the evaluation pairs
ZOO_CFG_EVAL_PAIRS = 10
# K1 at the configs' evaluation batch of 10: FADNet's [10,128,72,120] D 40 (phase 34) and
# CoEx's [10,48,136,240] D 48 (its config's batch; phase 28 evaluates at 2), each checked and
# timed in the dtype its trainer's evaluation runs (FADNet f32, CoEx bf16)
K1_EVAL10_SHAPES = {(10,) + FADNET_K1_SHAPE[1:]: "f32", (10,) + COEX_K1_SHAPE[1:]: "bf16"}
FADNET_OVERFIT_ARGS = ["--model", "FADNet", "--steps", "40", "--batch", "1", "--size", "192",
                       "384", "--max_disp", "64", "--lr", "4e-3", "--device", "cuda"]
# Training of FoundationStereo, FastFoundationStereo and MonSter (phases 49-51, in phases 26-34's
# loop): each SceneFlow config as written through `tools/train.py` for 4 steps, the trainer's
# evaluation of one batch at the config's EVALUATOR.BATCH_SIZE_PER_GPU (1, 1, 8) at 544x960,
# through K3 once a batch: FoundationStereo's vits cosine volume (C 96 + 32, G 8, C/G 16, D
# 192/4, divisor 1), FastFoundationStereo's of phase 47, MonSter's at IGEV's width at b8
FS_FAMILY_EVAL_BATCH = {"FoundationStereo": 1, "FastFoundationStereo": 1, "MonSter": 8}
FS_VITS_K3_SHAPE = (1, 128, 136, 240, 48, 8, 1)
MONSTER_EVAL_K3_SHAPE = (8,) + IGEV_K3_SHAPE[1:]
# their gradient bounds, relative to each tensor's largest magnitude: twice the worst f32 error
# of 3 runs on the card relative to its tensor (`fs_family_train_paths` says what they hold)
FS_FAMILY_BOUNDS = {"FoundationStereo": 0.33, "FastFoundationStereo": 0.54, "MonSter": 0.05}
FFS_OVERFIT_ARGS = ["--model", "FastFoundationStereo", "--steps", "40", "--batch", "1", "--size",
                    "192", "384", "--max_disp", "64", "--lr", "2e-4", "--device", "cuda"]
# the learning checks that launch no kernel of the port (phase label, model, arguments of
# `tools/overfit_check.py`): they run in worker processes beside the kernels' build (phase 2),
# which leaves the card idle (`start_beside_build`); STTR's (phase 25) trains through K4 and
# runs after the build
OVERFITS = [("15 LightStereo overfit", "LightStereo", OVERFIT_ARGS),
            ("30 GwcNet overfit", "GwcNet", ZOO_OVERFIT_ARGS),
            ("35 FADNet overfit (Lamb)", "FADNet", FADNET_OVERFIT_ARGS),
            ("45 IGEV overfit", "IGEV", IGEV_OVERFIT_ARGS),
            ("52 FastFoundationStereo overfit", "FastFoundationStereo", FFS_OVERFIT_ARGS)]
# the worker processes that run the gradient checks of phases 26-51 (`zoo_grad_check`, no kernel
# either) beside the build, each a third of the paths
GRAD_WORKERS = 3


# dense peaks: (memory bytes/s, bf16 tensor flop/s, f32 flop/s outside the tensor
# cores), NVIDIA data sheets
CARDS = {"H100 PCIe": (2.0e12, 756e12, 51e12), "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}


class SmokeFailure(Exception):
    pass


PHASE_SECONDS = {}  # phase → seconds, printed as each phase ends and once more at the end


def run_phase(label, fn, *args):
    """fn(*args), its seconds printed on a line of their own and kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[label] = time.perf_counter() - t0
    print(f"[phase-time] {label}: {PHASE_SECONDS[label]:.1f} s", flush=True)
    return out


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def peaks(name):
    for key, val in CARDS.items():  # most specific names first
        if key in name:
            return val
    raise SmokeFailure(f"no peak rates known for card {name!r}")


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_close(got, ref, rtol=8e-3, atol=1e-3):
    """|got - ref| <= rtol·|ref| + atol: one bf16 rounding of an f32 result."""
    return bool(((got.float() - ref).abs() <= rtol * ref.abs() + atol).all())


def bf16_close_flips(got, ref, allowance, share, what):
    """`bf16_close` for all but at most `share` of the elements (at least one),
    which may miss it by no more than `allowance`: where the plain version and
    the kernel each round an intermediate to bf16 (as the TPU kernel does),
    sums taken in two f32 orders may round one of them to two neighbours.
    Returns (elements beyond `bf16_close`, elements beyond it and the allowance)."""
    err = (got.float() - ref.float()).abs()
    tol = 8e-3 * ref.float().abs() + 1e-3
    beyond = int((err > tol).sum())
    over = err - tol - allowance
    n_over = int((over > 0).sum())
    check(n_over == 0, f"{what}: max-abs {err.max().item()} beyond 8e-3·|ref| + 1e-3 and the "
                       f"flip allowance at {n_over} elements (by up to {over.max().item()})")
    check(beyond <= max(1, share * err.numel()),
          f"{what}: {beyond} of {err.numel()} elements beyond 8e-3·|ref| + 1e-3 (share cap "
          f"{share})")
    return beyond, n_over


def rejected(got, ref, allowance, share):
    """For a control that rounds in the wrong place: whether `bf16_close_flips`
    rejects it, with (elements beyond `bf16_close`, beyond it and the allowance)."""
    try:
        bf16_close_flips(got, ref, allowance, share, "control")
    except SmokeFailure:
        pass
    else:
        return False, None
    err = (got.float() - ref.float()).abs()
    tol = 8e-3 * ref.float().abs() + 1e-3
    return True, (int((err > tol).sum()), int((err > tol + allowance).sum()))


def volume_bf16_check(got, ref, what):
    """bf16 K1/K3 against the plain version on the same bf16 inputs (which
    rounds each product to bf16, as JAX does): `bf16_close` at every element,
    and bit-equal at all but VOLUME_FLIP_SHARE of them. Returns (max-abs, share
    of elements not bit-equal)."""
    err = (got.float() - ref.float()).abs().max().item()
    check(bf16_close(got, ref.float()), f"{what}: max-abs {err} beyond 8e-3·|ref| + 1e-3")
    share = (got != ref).float().mean().item()
    check(share <= VOLUME_FLIP_SHARE,
          f"{what}: {share:.3g} of the elements not bit-equal (cap {VOLUME_FLIP_SHARE})")
    return err, share


def volume_f32_check(got, ref, cg, what):
    """f32 K1/K3 against the plain version on the same inputs: max-abs <= 1e-5
    and, where a group has fewer than F32_EXACT_CG channels, every element bit
    for bit (the kernel sums in the order of PyTorch's CUDA mean there,
    `csrc/cost_volume.cu`). Returns (max-abs, share of elements not
    bit-equal)."""
    err = (got - ref).abs().max().item()
    check(err <= 1e-5, f"{what}: max-abs {err} > 1e-5")
    share = (got != ref).float().mean().item()
    check(cg >= F32_EXACT_CG or share == 0,
          f"{what}: {share:.3g} of the elements not bit-equal (cg {cg} < {F32_EXACT_CG})")
    return err, share


def volume_rejected(bad, ref):
    """For the unrounded control: whether `volume_bf16_check` rejects it, and
    its share of elements that are not bit-equal."""
    try:
        volume_bf16_check(bad, ref, "control")
    except SmokeFailure:
        return True, (bad != ref).float().mean().item()
    return False, (bad != ref).float().mean().item()


def device_ms(fn, key="cv_kernel", iters=20):
    """Device time per launch of the kernels whose name holds `key`, from
    torch.profiler over `iters` back-to-back calls of `fn` (the launch overhead
    that CUDA events over back-to-back launches also count is left out),
    averaged over the launches the trace recorded. The profiler records a
    warm-up step of `iters` calls first and reads only the step after it:
    the trace may miss launches at its start (one run saw 9 of 20 without
    the warm-up step). The scheduled trace keeps its cycle's events
    (`acc_events`: without it the profiler clears them at the cycle's end,
    and one run saw 3, 0 and 0 of 20 in three traces); a trace that still
    sees fewer than half is taken again, up to six times, every second
    time as one plain trace of the CPU and the card, as `tools/bench.py:
    profile_paths` takes its model traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt % 2 == 0:
            with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key]
        n = sum(e.count for e in rows)  # the trace may miss a launch at its edge
        if iters // 2 <= n <= iters:
            break
        print(f"[time] profiler saw {n} launches of {key!r} in {iters} calls; tracing again")
    check(iters // 2 <= n <= iters, f"profiler saw {n} launches of {key!r} in {iters} calls")
    return sum(e.self_device_time_total for e in rows) / 1e3 / n


def bf16_flip(u, err):
    """Where an f32 value u >= 0, rounded to bf16, lies within `err` of the
    midpoint between its rounding r and r's neighbour on u's side: the
    distance to that neighbour (another sum order may round u there), else 0."""
    import torch

    r = u.bfloat16()
    step = torch.sign(u - r.float()).to(torch.int16)
    other = (r.view(torch.int16) + step).view(torch.bfloat16).float()
    amb = (step != 0) & ((u - (r.float() + other) / 2).abs() <= err)
    return torch.where(amb, (other - r.float()).abs(), torch.zeros_like(u))


def k2_flip_allowance(x, args):
    """Per output element of K2's bf16 plain version: the most that rounding
    h or d to bf16 the other way can move it, where their f32 pre-rounding
    value lies within the error bound of two f32 sum orders ((n + 2)·2^-23
    of the sum of |terms| over n terms) of a rounding midpoint; 0 elsewhere.
    Relu6 is 1-Lipschitz, so the bound propagates linearly."""
    import torch
    import torch.nn.functional as F

    w1, b1, dw, b2, w2, _ = (a.float() for a in args)
    xf, ch, eps = x.float(), w1.shape[1], 2.0 ** -23
    pre = torch.einsum("bchw,cd->bdhw", xf, w1) + b1[:, None, None]
    mag = torch.einsum("bchw,cd->bdhw", xf.abs(), w1.abs()) + b1.abs()[:, None, None]
    u_h = pre.clamp(0.0, 6.0)
    flip_h = bf16_flip(u_h, (xf.shape[1] + 2) * eps * mag)
    h = u_h.bfloat16().float()
    k = dw.t().reshape(ch, 1, 3, 3)
    pre_d = F.conv2d(h, k, b2, padding=1, groups=ch)
    mag_d = F.conv2d(h.abs(), k.abs(), b2.abs(), padding=1, groups=ch)
    shift = F.conv2d(flip_h, k.abs(), padding=1, groups=ch)  # what h's flips move pre_d by
    flip_d = bf16_flip(pre_d.clamp(0.0, 6.0), 11 * eps * mag_d + shift)
    return torch.einsum("bchw,cd->bdhw", flip_d + shift, w2.abs())


def k4_flip_allowance(args, nh, masked):
    """Per output element of K4's bf16 plain version: the most that rounding
    p to bf16 the other way can move it, where p's f32 value lies within the
    error bound of two implementations of its f32 arithmetic of a rounding
    midpoint: each score within (hd + 2)·2^-23 of its sum of |terms|, the row
    max and sum within the row's worst score error, exp and the W-term sum
    within (W + 16)·2^-23; 0 elsewhere."""
    import torch

    from openstereo_tpu_torch.ops.rel_attention import rel_index

    q, k, v, ke, qe = (a.float() for a in args)
    b, w, e = q.shape
    hd, eps = e // nh, 2.0 ** -23
    idx = rel_index(w, q.device)
    qh, kh, vh = (t.reshape(b, w, nh, hd) for t in (q, k, v))
    k_r, q_r = (t[idx].reshape(w, w, nh, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    ds = (torch.einsum("bihc,bjhc->bhij", qh.abs(), kh.abs())
          + torch.einsum("bihc,ijhc->bhij", qh.abs(), k_r.abs())
          + torch.einsum("bjhc,ijhc->bhij", kh.abs(), q_r.abs())) * ((hd + 2) * eps)
    if masked:
        above = torch.triu(torch.ones(w, w, dtype=torch.bool, device=q.device), 1)
        s, ds = s.masked_fill(above, -1e30), ds.masked_fill(above, 0.0)
    p = torch.softmax(s, dim=-1)
    dm = ds.amax(dim=-1, keepdim=True)
    rel = ds + 2 * dm + (p * ds).sum(dim=-1, keepdim=True) + (w + 16) * eps
    flip = bf16_flip(p, p * rel)
    return torch.einsum("bhij,bjhc->bihc", flip, vh.abs()).reshape(b, w, e)


def k2_misrounded(x, args, residual, round_h, round_d):
    """A control for the K2 check: the plain version's arithmetic with h or d
    left in f32 where the TPU kernel rounds it to bf16."""
    import torch
    import torch.nn.functional as F

    w1, b1, dw, b2, w2, b3 = (a.float() for a in args)
    xf, ch = x.float(), w1.shape[1]
    h = (torch.einsum("bchw,cd->bdhw", xf, w1) + b1[:, None, None]).clamp(0.0, 6.0)
    h = h.bfloat16().float() if round_h else h
    d = F.conv2d(h, dw.t().reshape(ch, 1, 3, 3), b2, padding=1, groups=ch).clamp(0.0, 6.0)
    d = d.bfloat16().float() if round_d else d
    y = torch.einsum("bchw,cd->bdhw", d, w2) + b3[:, None, None]
    return (y + xf if residual else y).to(x.dtype)


def k4_misrounded(args, nh, masked, mode):
    """A control for the K4 check: the plain version's arithmetic with p left
    in f32 (mode "p f32"), or with exp(s - m) rounded to bf16 before the
    division by the row sum l (mode "exp before /l", as a flash-attention
    style kernel rounds), where the TPU kernel rounds p = exp(s - m) / l."""
    import torch

    from openstereo_tpu_torch.ops.rel_attention import rel_index

    q, k, v, ke, qe = (a.float() for a in args)
    b, w, e = q.shape
    hd = e // nh
    idx = rel_index(w, q.device)
    qh, kh, vh = (t.reshape(b, w, nh, hd) for t in (q, k, v))
    k_r, q_r = (t[idx].reshape(w, w, nh, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    if masked:
        s = s.masked_fill(torch.triu(torch.ones(w, w, dtype=torch.bool, device=q.device), 1),
                          -1e30)
    if mode == "p f32":
        out = torch.einsum("bhij,bjhc->bihc", torch.softmax(s, dim=-1), vh)
    else:
        ex = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = (torch.einsum("bhij,bjhc->bihc", ex.bfloat16().float(), vh)
               / ex.sum(dim=-1).transpose(1, 2)[..., None])
    return out.reshape(b, w, e).to(args[2].dtype)


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {name}")
    return smi, name


def phase_build():
    from openstereo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        print(f"[build]   {name}: {path}")
    # ptxas's figures for the tensor-core kernels (namespace tc) of K4 and K2
    # and for the cost-volume kernel of K1 and K3
    ptxas = {}
    for name, key in (("rel_attention", "2tc"), ("fused_mbconv", "2tc"),
                      ("cost_volume", "cv_kernel")):
        ptxas[name] = [e for e in build.ptxas_info(name) if key in e["entry"]]
        check(ptxas[name], f"no ptxas figures for {name}'s kernels ({key})")
        for e in ptxas[name]:
            print(f"[ptxas] {name} {e['entry'][max(0, e['entry'].find(key)):][:48]}: "
                  f"{e['registers']} registers, spill "
                  f"stores {e['spill_stores']} B, spill loads {e['spill_loads']} B, static "
                  f"shared memory {e['smem']} B")
    return ptxas


def phase_k1(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(1)
    errs = {}
    for (b, c, h, w, d), tag in ((K1_SHAPE, "main"), (COEX_K1_SHAPE, "CoEx"),
                                 (FADNET_K1_SHAPE, "FADNet"),
                                 ((1, 8, 3, 37, 48), "ragged W"),
                                 ((2, 24, 5, 130, 100), "ragged W, D>64"),
                                 ((1, 4, 2, 6, 10), "d >= W")):
        left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
        ref = ops.correlation_volume(left, right, d)
        got = ops.corr_volume(left, right, d)
        err32, bits32 = volume_f32_check(got, ref, c, f"K1 f32 {tag} {(b, c, h, w, d)}")
        lb, rb = left.bfloat16(), right.bfloat16()
        ref16 = ops.correlation_volume(lb, rb, d)
        got16 = ops.corr_volume(lb, rb, d)
        err16, share = volume_bf16_check(got16, ref16, f"K1 bf16 {tag}")
        control = ""
        if tag in ("main", "CoEx", "FADNet"):  # the unrounded control: products in f32
            no, c_share = volume_rejected(
                ops.correlation_volume(lb.float(), rb.float(), d).bfloat16(), ref16)
            check(no, f"K1 bf16 {tag}: the unrounded control passes the check")
            control = f"; unrounded control rejected ({c_share:.3g} not bit-equal)"
        if w < d:
            check(not got16[:, w:].any(), "K1: planes with d >= W are not zero")
        print(f"[K1] {tag} {(b, c, h, w, d)}: f32 max-abs {err32:.3g} (tol 1e-5), {bits32:.3g} "
              f"not bit-equal (cap 0 where C < {F32_EXACT_CG}), bf16 max-abs {err16:.3g} (tol "
              f"8e-3·|ref| + 1e-3), {share:.3g} not bit-equal "
              f"(cap {VOLUME_FLIP_SHARE}){control}")
        errs[tag] = (err32, err16, share)
    return errs


def k2_inputs(shape, dev, dtype, g):
    import torch

    b, h, w, cin, ch, cout, _ = shape
    # scaled so that both relu6 clamps (at 0 and at 6) are active
    x = torch.randn(b, cin, h, w, generator=g) * 3.0
    ws = [torch.randn(cin, ch, generator=g) * cin ** -0.5, torch.randn(ch, generator=g) * 0.5,
          torch.randn(9, ch, generator=g) * 0.6, torch.randn(ch, generator=g) * 0.1,
          torch.randn(ch, cout, generator=g) * ch ** -0.5, torch.randn(cout, generator=g) * 0.1]
    args = [t.to(dev, dtype) if i % 2 == 0 else t.to(dev) for i, t in enumerate(ws)]
    return x.to(dev, dtype), args


def phase_k2(dev):
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.ops.kernels import build

    g = torch.Generator().manual_seed(2)
    lib = build.load("fused_mbconv")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst32 = worst16 = 0.0
    controls, by_shape = {}, {}
    for shape in K2_ALL_SHAPES:
        b, h, w, cin, ch, cout = shape[:6]
        splits = lib.fused_mbconv_splits(b, h, w, ch, 1)
        chunks = -(-ch // 32)
        check(splits >= 1 and (splits - 1) * -(-chunks // splits) < chunks,
              f"K2 {shape[:6]}: the launcher picks {splits} splits of {chunks} chunks")
        if sms == 132:
            check(splits == K2_SPLITS_132[(b, h, w, ch)],
                  f"K2 {shape[:6]}: the launcher picks S = {splits}, the plan says "
                  f"{K2_SPLITS_132[(b, h, w, ch)]}")
        x, args = k2_inputs(shape, dev, torch.float32, g)
        x16, args16 = x.bfloat16(), [a.bfloat16() if i % 2 == 0 else a for i, a in enumerate(args)]
        for res in ((True, False) if cin == cout else (False,)):
            ref = ops.mbconv_plain(x, *args, residual=res)
            got = ops.fused_mbconv(x, *args, residual=res)
            err32 = (got - ref).abs().max().item()
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"K2 f32 {shape[:6]} residual={res}: max-abs {err32} beyond rtol 1e-4, atol 1e-4")
            ref16 = ops.mbconv_plain(x16, *args16, residual=res)
            allowance = k2_flip_allowance(x16, args16)
            got16 = ops.fused_mbconv(x16, *args16, residual=res)
            err16, beyond = k2_bf16_error(got16, ref16, allowance, f"{shape[:6]} residual={res}")
            # the controls: h or d left in f32 must not pass the same check
            for name, rh, rd in (("h f32", False, True), ("d f32", True, False)):
                bad = k2_misrounded(x16, args16, res, rh, rd)
                no, counts = rejected(bad, ref16, allowance, K2_FLIP_SHARE)
                check(no, f"K2 bf16 {shape[:6]} residual={res}: the control with {name} "
                          f"passes the check")
                controls[(shape[:6], res, name)] = counts
            print(f"[K2] {shape[:6]} residual={res}, S={splits}: f32 max-abs {err32:.3g} "
                  f"(tol 1e-4 + 1e-4·|ref|), bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3; "
                  f"{beyond} of {got16.numel()} beyond it, within the flip allowance); "
                  f"controls rejected, beyond / over the allowance: h f32 "
                  f"{controls[(shape[:6], res, 'h f32')]}, d f32 "
                  f"{controls[(shape[:6], res, 'd f32')]}")
            worst32, worst16 = max(worst32, err32), max(worst16, err16)
            e32, e16 = by_shape.get(shape, (0.0, 0.0))
            by_shape[shape] = (max(e32, err32), max(e16, err16))
    # the bf16 kernel at split counts other than the launcher's, through the launcher:
    # every S of a ragged 3-chunk case (Cin 24 padded), and the 30-chunk 17x30 shape
    # unsplit and one chunk per block
    for shape, res, splits in K2_SPLIT_CASES:
        x, args = k2_inputs(shape, dev, torch.bfloat16, g)
        ref = ops.mbconv_plain(x, *args, residual=res)
        allowance = k2_flip_allowance(x, args)
        for sp in splits:
            got = k2_launch_forced(lib, x, args, res, sp)
            err16, beyond = k2_bf16_error(got, ref, allowance, f"{shape[:6]} residual={res} S={sp}")
            print(f"[K2] {shape[:6]} residual={res}, S={sp} (forced): bf16 max-abs {err16:.3g} "
                  f"(tol 8e-3·|ref| + 1e-3; {beyond} beyond it, within the flip allowance)")
            worst16 = max(worst16, err16)
    return worst32, worst16, controls, by_shape


def k2_launch_forced(lib, x, args, residual, splits):
    """The bf16 K2 launcher called at a split count of our choosing (the wrapper
    takes the launcher's own); not counted as a launch of the main path."""
    import torch

    from openstereo_tpu_torch.ops import kernels

    b, cin, h, w = x.shape
    ch, cout = args[0].shape[1], args[4].shape[1]
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, b, cout, h, w), dtype=torch.float32, device=x.device)
    err = lib.fused_mbconv_launch(x.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
                                  ws.data_ptr() if splits > 1 else None, b, cin, ch, cout, h, w,
                                  int(residual), splits, 1, kernels.stream_handle(x.device))
    check(err == 0, f"K2 bf16 launcher at S={splits}: cudaError_t {err}")
    return out


def k2_bf16_error(got, ref, allowance, what):
    """bf16 K2 against its plain version on the same bf16 inputs (which rounds h
    and d to bf16 where the TPU kernel does): (max-abs, elements beyond
    `bf16_close`), raising as `bf16_close_flips` says."""
    beyond, _ = bf16_close_flips(got, ref, allowance, K2_FLIP_SHARE, f"K2 bf16 {what}")
    return (got.float() - ref.float()).abs().max().item(), beyond


def k4_inputs(shape, dev, g):
    """q, k, v [B,W,E] and ke, qe [2W-1,E], f32; q and qe scaled by hd^-1/2
    as the model scales them, so the logits have the model's spread."""
    import torch

    b, w, e, nh = shape[:4]
    scale = (e // nh) ** -0.5
    q, k, v = (torch.randn(b, w, e, generator=g) for _ in range(3))
    ke, qe = (torch.randn(2 * w - 1, e, generator=g) * 0.5 for _ in range(2))
    return [t.to(dev) for t in (q * scale, k, v, ke, qe * scale)]


def k4_errors(args, nh, masked, need_raw, controls=None):
    """K4 against its plain version on the same inputs: (out max-abs, raw
    max-abs on finite entries or None, out elements beyond `bf16_close`),
    raising beyond the tolerances (f32: 1e-4 as
    tests/test_rel_attention.py; bf16: one bf16 rounding of out as
    `bf16_close_flips` says, raw at rtol 1e-3; the bf16 plain version rounds
    p to bf16 before p·v, as the TPU kernel does). With a dict `controls`
    (bf16), the misrounded controls must fail the same check; their counts
    go there."""
    import torch

    from openstereo_tpu_torch import ops

    bf16 = args[0].dtype == torch.bfloat16
    ref, ref_raw = ops.rel_attention_plain(*args, nh, masked, need_raw)
    ref = ref.float()
    got, raw = ops.rel_attention(*args, nh, masked, need_raw)
    err = (got.float() - ref).abs().max().item()
    beyond = 0
    if bf16:
        allowance = k4_flip_allowance(args, nh, masked)
        beyond, _ = bf16_close_flips(got, ref, allowance, K4_FLIP_SHARE, "out")
        for mode in () if controls is None else ("p f32", "exp before /l"):
            no, controls[mode] = rejected(k4_misrounded(args, nh, masked, mode), ref, allowance,
                                          K4_FLIP_SHARE)
            check(no, f"the control with {mode} passes the check")
    else:
        check(bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"out max-abs {err} beyond rtol 1e-4, atol 1e-4")
    if not need_raw:
        check(raw is None, "raw returned without need_raw")
        return err, None, beyond
    fin = ref_raw.abs() < 1e20
    check(bool((raw[~fin] < -1e29).all()), "masked raw entries are not ~-1e30 per head")
    rtol, atol = (1e-3, 1e-4) if bf16 else (1e-4, 1e-4)
    rerr = (raw[fin] - ref_raw[fin]).abs()
    check(bool((rerr <= atol + rtol * ref_raw[fin].abs()).all()),
          f"raw max-abs {rerr.max().item()} beyond rtol {rtol}, atol {atol}")
    return err, rerr.max().item(), beyond


def phase_k4(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(4)
    worst = {"f32": 0.0, "bf16": 0.0}
    controls = {}
    cases = [(*key, "main path") for key in K4_SHAPES] + K4_EDGES
    for b, w, e, nh, masked, need_raw, what in cases:
        args = k4_inputs((b, w, e, nh), dev, g)
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            bf16 = dtype == torch.bfloat16
            ctl = {} if bf16 and what == "main path" else None
            try:
                err, rerr, beyond = k4_errors([a.to(dtype) for a in args], nh, masked, need_raw,
                                              ctl)
            except SmokeFailure as exc:
                raise SmokeFailure(f"K4 {tag} {(b, w, e, nh, masked, need_raw)} ({what}): {exc}")
            worst[tag] = max(worst[tag], err)
            if ctl:
                controls[(b, w, e, nh, masked, need_raw)] = ctl
            flips = f" ({beyond} of {b * w * e} beyond bf16_close, within the flip allowance)"
            print(f"[K4] {tag} B={b} W={w} E={e} heads={nh} masked={masked} raw={need_raw} "
                  f"({what}): out max-abs {err:.3g}{flips if bf16 else ''}"
                  f", raw max-abs {'-' if rerr is None else f'{rerr:.3g}'}"
                  f"{f'; controls rejected, beyond / over the allowance: {ctl}' if ctl else ''}")
    # W beyond what the tiles take: the f32 score tile, and the bf16 raw tile
    for dtype in (torch.float32, torch.bfloat16):
        args = [a.to(dtype) for a in k4_inputs((1, 2048, 32, 2), dev, g)]
        try:
            ops.rel_attention(*args, 2, False, True)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"K4 {dtype} took W = 2048 with raw, beyond its shared memory")
    print("[K4] W = 2048 with raw refused in f32 and bf16 (the tiles exceed shared memory)")
    torch.cuda.synchronize()
    return worst["f32"], worst["bf16"], controls


def synthetic_pairs(size=(H, W)):
    rng = np.random.RandomState(0)
    for _ in range(N_PAIRS):
        left = (rng.rand(*size, 3) * 255).astype(np.uint8).astype(np.float32)
        yield left, np.roll(left, -12, axis=1)


def phase_slice(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(CFG_FILE))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] LightStereo-S ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")

    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(  # the main path
        {"corr_volume": {K1_SHAPE: 1}, "fused_mbconv": K2_SHAPES},
        lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[slice] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))
    for d in wired + eager:
        check(d.shape == (H, W) and np.isfinite(d).all(), "bf16 disparity not finite [H,W]")
    check(mean16 <= 0.5, f"bf16 kernel vs eager mean-abs {mean16} px > 0.5")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    errs32 = []
    for p in pairs:
        a = run_pair(set_kernels(model32, True), tf, *p)
        b = run_pair(set_kernels(model32, False), tf, *p)
        errs32.append(float(np.abs(a - b).max()))
    max32 = max(errs32)
    check(max32 <= 5e-3, f"f32 kernel vs eager max-abs {max32} px > 5e-3")
    rng = [float(wired[0].min()), float(wired[0].max())]
    print(f"[slice] f32 kernel vs eager: max-abs {max32:.3g} px (tol 5e-3); "
          f"bf16 kernel vs eager: mean-abs {mean16:.3g} px (tol 0.5); "
          f"bf16 disparity range {rng[0]:.2f}..{rng[1]:.2f}")
    return model, launches, per_frame, max32, mean16


def record_path(want, run):
    """Zero the launch counts, `run()` a path over N_PAIRS frames, and hold the
    record of every kernel against `want` (kernel → shape key → launches per
    frame); a kernel not in `want` must not have launched."""
    import torch

    from openstereo_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    per_frame = {}
    for name, n in launches.items():
        shapes = dict(kernels.launch_shapes[name])
        expected = want.get(name, {})
        check(n == sum(expected.values()) * N_PAIRS,
              f"{name} launches {n} over {N_PAIRS} frames != {sum(expected.values())} per frame")
        check(all(k % N_PAIRS == 0 for k in shapes.values()),
              f"{name} launch shapes {shapes} differ between frames")
        if expected:
            per_frame[name] = {k: c // N_PAIRS for k, c in shapes.items()}
            check(per_frame[name] == expected,
                  f"{name} launch shapes per frame {per_frame[name]} != expected {expected}")
    return out, launches, per_frame


def phase_sttr(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(STTR_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs(STTR_HW))
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[sttr] STTR ({n_params} parameters), {STTR_HW[0]}x{STTR_HW[1]} b1 bf16, "
          f"{N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(
        {"rel_attention": K4_SHAPES}, lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[record] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")
    launches, per_frame = launches["rel_attention"], per_frame["rel_attention"]

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    for d in wired + eager:
        check(d.shape == STTR_HW and np.isfinite(d).all(), "bf16 disparity not finite [540,960]")
    diffs = [np.abs(a - b) for a, b in zip(wired, eager)]
    mean16 = max(float(d.mean()) for d in diffs)
    share16 = min(float((d <= 3.0).mean()) for d in diffs)
    print(f"[sttr] bf16 kernel vs eager: mean-abs {mean16:.4g} px, share within 3 px "
          f"{share16:.5f} (worst pair; tol >= 0.9); disparity range "
          f"{wired[0].min():.2f}..{wired[0].max():.2f}")
    check(share16 >= 0.9, f"bf16 kernel vs eager: only {share16:.4f} of pixels within 3 px")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    captured = []
    hook = model32.transformer.register_forward_hook(
        lambda mod, inp, out: captured.append(out.float()))
    raw_err = 0.0
    share32, max32 = 1.0, 0.0
    try:
        for p in pairs:
            outs, raws = {}, {}
            for path in ("kernels", "eager"):
                set_kernels(model32, path == "kernels")
                outs[path] = run_pair(model32, tf, *p)
                raws[path] = captured.pop()
            ref = raws["eager"]
            fin = torch.isfinite(ref)
            err = (raws["kernels"][fin] - ref[fin]).abs().max().item()
            raw_err = max(raw_err, err / ref[fin].abs().max().item())
            check(bool((raws["kernels"][~fin] < -1e29).all()), "masked raw entries are finite")
            d = np.abs(outs["kernels"] - outs["eager"])
            share32, max32 = min(share32, float((d <= 5e-3).mean())), max(max32, float(d.max()))
    finally:
        hook.remove()
    print(f"[sttr] f32 kernel vs eager: last-layer raw attention max-abs {raw_err:.3g}·max|raw| "
          f"(tol 1e-4), disparity max-abs {max32:.4g} px, share within 5e-3 px {share32:.6f} "
          f"(tol >= 0.999)")
    check(raw_err <= 1e-4, f"f32 raw attention max-abs {raw_err}·max|raw| > 1e-4")
    check(share32 >= 0.999, f"f32 kernel vs eager: only {share32} of pixels within 5e-3 px")
    del model32
    torch.cuda.empty_cache()
    return model, launches, per_frame, (raw_err, max32, share32, mean16, share16)


def k1_work(shape, elem):
    b, c, h, w, d = shape
    nbytes = (2 * b * c * h * w + b * d * h * w) * elem
    flops = 2 * b * c * h * sum(max(w - k, 0) for k in range(d))  # products with w - d >= 0
    return nbytes, flops


def k2_work(shape, elem):
    b, h, w, cin, ch, cout, _ = shape
    weights = (cin * ch + 9 * ch + ch * cout) * elem + (2 * ch + cout) * 4
    nbytes = b * h * w * (cin + cout) * elem + weights
    flops = 2 * b * h * w * (cin * ch + 9 * ch + ch * cout)
    return nbytes, flops


def bound(nbytes, flops, card):
    t_bytes, t_ops = nbytes / card[0] * 1e3, flops / card[1] * 1e3  # ms, bf16 peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def volume_timing(dev, per_frame, card, g, tag, grouped):
    """K1 (`grouped` False) or K3 at each shape a path launched it at
    (`per_frame`: shape → launches per frame), bf16: CUDA events over
    back-to-back launches, device time per launch (torch.profiler), the
    plain version, the bound; summed per frame with the launch counts."""
    import torch

    from openstereo_tpu_torch import ops

    out = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "yardstick_ms": None, "bound_ms": 0.0,
           "launches_per_frame": sum(per_frame.values()), "shapes": []}
    t_bytes = t_ops = 0.0
    for shape, count in sorted(per_frame.items(), reverse=True):
        b, c, h, w, d = shape[:5]
        left, right = (torch.randn(b, c, h, w, generator=g).to(dev, torch.bfloat16)
                       for _ in range(2))
        if grouped:  # shape[6], where given, is K3's divisor (1: the cosine volume's sum)
            div = shape[6] if len(shape) > 6 else None
            kernel = lambda: ops.gwc_volume(left, right, d, shape[5], div)  # noqa: E731
            plain = lambda: ops.build_gwc_volume(left, right, d, shape[5], div)  # noqa: E731
            nbytes, flops = k3_work(shape, 2)
        else:
            kernel = lambda: ops.corr_volume(left, right, d)  # noqa: E731
            plain = lambda: ops.correlation_volume(left, right, d)  # noqa: E731
            nbytes, flops = k1_work(shape, 2)
        t_k, t_d, t_p = time_ms(kernel), device_ms(kernel), time_ms(plain, iters=10)
        t_b, by = bound(nbytes, flops, card)
        t_bytes += count * nbytes / card[0] * 1e3
        t_ops += count * flops / card[1] * 1e3
        for key, t in (("ms", t_k), ("device_ms", t_d), ("plain_ms", t_p), ("bound_ms", t_b)):
            out[key] += count * t
        out["shapes"].append({"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                              "device_ms": t_d, "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                              "bytes": nbytes, "flops": flops})
        print(f"[time] {tag} {shape} x{count} bf16: kernel {t_k:.4f} ms (CUDA events over "
              f"back-to-back launches), device {t_d:.4f} ms per launch (torch.profiler), plain "
              f"{t_p:.4f} ms, bound {t_b:.4f} ms ({by}; {nbytes} B, {flops} flop; "
              f"{t_b / t_d:.1%} of the device time); no single PyTorch call computes it")
        del left, right
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out["bound_share"] = out["bound_ms"] / out["device_ms"]
    return out


def k1_timing(dev, per_frame, card, g, tag="K1"):
    return volume_timing(dev, per_frame, card, g, tag, grouped=False)


def k2_timing(dev, per_frame, card, g, tag="K2"):
    """K2 at each shape a path launched it at, bf16: the kernel, its plain
    version, the cuDNN pw→dw→pw chain with folded BN (a yardstick, not one
    call), the bound; summed per frame with the launches of `per_frame`."""
    import torch
    import torch.nn.functional as F

    from openstereo_tpu_torch import ops

    k2 = {"ms": 0.0, "plain_ms": 0.0, "yardstick_ms": 0.0, "bound_ms": 0.0, "shapes": [],
          "launches_per_frame": sum(per_frame.values())}
    t_bytes = t_ops = 0.0
    for shape, count in sorted(per_frame.items(), reverse=True):
        res_ = shape[-1]
        x, args = k2_inputs(shape, dev, torch.bfloat16, g)
        w1, b1, dw, b2, w2, b3 = args
        cin, ch = w1.shape
        w1c, dwc, w2c = (w1.t().reshape(ch, cin, 1, 1).contiguous(),
                         dw.t().reshape(ch, 1, 3, 3).contiguous(),
                         w2.t().reshape(-1, ch, 1, 1).contiguous())
        b1c, b2c, b3c = b1.bfloat16(), b2.bfloat16(), b3.bfloat16()

        def cudnn_chain():
            y = F.conv2d(x, w1c, b1c).clamp_(0, 6)
            y = F.conv2d(y, dwc, b2c, padding=1, groups=ch).clamp_(0, 6)
            y = F.conv2d(y, w2c, b3c)
            return y + x if res_ else y

        t_k = time_ms(lambda: ops.fused_mbconv(x, *args, residual=res_))
        t_p = time_ms(lambda: ops.mbconv_plain(x, *args, residual=res_), iters=10)
        t_y = time_ms(cudnn_chain)
        nbytes, flops = k2_work(shape, 2)
        t_b, by = bound(nbytes, flops, card)
        t_bytes += count * nbytes / card[0] * 1e3
        t_ops += count * flops / card[1] * 1e3
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("yardstick_ms", t_y), ("bound_ms", t_b)):
            k2[key] += count * t
        k2["shapes"].append({"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                             "plain_ms": t_p, "yardstick_ms": t_y, "bound_ms": t_b, "bound_by": by})
        print(f"[time] {tag} {shape} x{count} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"cuDNN chain {t_y:.4f} ms, bound {t_b:.4f} ms ({by})")
        del x, args
    k2["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] {tag} per frame ({k2['launches_per_frame']} launches): kernel "
          f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, cuDNN chain "
          f"{k2['yardstick_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms")
    return k2


def phase_timing(dev, model, card, per_frame):
    import torch

    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels

    res = bench_eager_vs_kernels(model, groups=8, reps=20)
    for path in ("eager", "kernels"):
        print(f"[time] LightStereo-S {path}: {res[path]['fps']:.2f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 20 chained frames, spread {res[path]['group_spread']:.1%}); host issue "
              f"{res[path]['host_issue_ms']:.3f} ms/frame")
    g = torch.Generator().manual_seed(3)
    k1 = k1_timing(dev, per_frame["corr_volume"], card, g)
    k2 = k2_timing(dev, per_frame["fused_mbconv"], card, g)
    return res, k1, k2


def k4_work(shape, elem):
    """Bytes (q, k, v, out and both tables once, raw f32 when asked), flops
    (8·W²·E per line: three score products and p·v) and exponentials."""
    b, w, e, nh, masked, need_raw = shape
    nbytes = (4 * b * w * e + 2 * (2 * w - 1) * e) * elem + (b * w * w * 4 if need_raw else 0)
    return nbytes, 8 * b * w * w * e, b * nh * w * w


def phase_timing_sttr(dev, model, card, per_frame):
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.models.sttr.transformer import rel_attention_eager
    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels, profile_paths

    res = bench_eager_vs_kernels(model, groups=4, reps=3, size=STTR_HW)
    for path in ("eager", "kernels"):
        print(f"[time] STTR {path}: {res[path]['fps']:.3f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 3 chained frames); host issue {res[path]['host_issue_ms']:.3f} ms/frame")
    prof = profile_paths(model, 2, str(OUT_DIR / "sttr_profile"), size=STTR_HW)
    for path, r in prof.items():
        r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / res[path]["ms_per_frame"]
        top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                        for t in r["top"][:6])
        print(f"[profile] STTR {path}: device busy {r['device_busy_ms_per_frame']:.3f} ms/frame, "
              f"{r['device_ops_per_frame']:g} device operations a frame, idle share "
              f"{r['idle_share']:.4f} (against {res[path]['ms_per_frame']:.3f} ms/frame untraced); "
              f"top: {top}")

    g = torch.Generator().manual_seed(5)
    k4 = {"ms": 0.0, "plain_ms": 0.0, "yardstick_ms": 0.0, "bound_ms": 0.0, "exp_count": 0,
          "shapes": [], "launches_per_frame": sum(per_frame.values())}
    t_bytes = t_ops = 0.0
    for shape, count in sorted(per_frame.items(), reverse=True):
        b, w, e, nh, masked, need_raw = shape
        args = [a.bfloat16() for a in k4_inputs(shape, dev, g)]
        t_k = time_ms(lambda: ops.rel_attention(*args, nh, masked, need_raw), iters=20, warmup=2)
        t_p = time_ms(lambda: ops.rel_attention_plain(*args, nh, masked, need_raw), iters=3,
                      warmup=1)
        t_y = time_ms(lambda: rel_attention_eager(*args, nh, masked), iters=10, warmup=2)
        nbytes, flops, exps = k4_work(shape, 2)
        t_b, by = bound(nbytes, flops, card)
        t_bytes += count * nbytes / card[0] * 1e3
        t_ops += count * flops / card[1] * 1e3
        k4["exp_count"] += count * exps
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("yardstick_ms", t_y), ("bound_ms", t_b)):
            k4[key] += count * t
        k4["shapes"].append({"shape": list(shape), "launches_per_frame": count, "ms": t_k,
                             "plain_ms": t_p, "yardstick_ms": t_y, "bound_ms": t_b, "bound_by": by,
                             "bytes": nbytes, "flops": flops, "exps": exps})
        print(f"[time] K4 {shape} x{count} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"eager einsum chain {t_y:.4f} ms, bound {t_b:.4f} ms ({by}; {nbytes} B, "
              f"{flops} flop, {exps} exp)")
    k4["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] K4 per frame ({k4['launches_per_frame']} launches): kernel {k4['ms']:.4f} ms, "
          f"plain {k4['plain_ms']:.4f} ms, eager einsum chain {k4['yardstick_ms']:.4f} ms, "
          f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), {k4['exp_count']} exponentials")
    return res, prof, k4


def phase_k3(dev):
    import torch

    from openstereo_tpu_torch import ops

    g = torch.Generator().manual_seed(6)
    errs = {}
    cfnet = [(shape, f"CFNet {scale}") for shape, scale in zip(CFNET_K3_SHAPES,
                                                                ("1/8", "1/16", "1/32"))]
    igev = [(IGEV_K3_SHAPE, "IGEV"), (IGEV_EVAL_K3_SHAPE, "IGEV evaluation"),
            (IGEVPP_K3_SHAPE, "IGEV++")]
    for (b, c, h, w, d, gr), tag in [(K3_SHAPE, "main path")] + cfnet + igev + K3_EDGES:
        left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
        ref = ops.build_gwc_volume(left, right, d, gr)
        got = ops.gwc_volume(left, right, d, gr)
        check(got.shape == (b, gr, d, h, w), f"K3 {tag}: shape {tuple(got.shape)}")
        err32, bits32 = volume_f32_check(got, ref, c // gr, f"K3 f32 {tag} {(b, c, h, w, d, gr)}")
        lb, rb = left.bfloat16(), right.bfloat16()
        ref16 = ops.build_gwc_volume(lb, rb, d, gr)
        got16 = ops.gwc_volume(lb, rb, d, gr)
        err16, share = volume_bf16_check(got16, ref16, f"K3 bf16 {tag}")
        control = ""
        if tag == "main path" or tag.startswith(("CFNet", "IGEV")):  # the unrounded control
            no, c_share = volume_rejected(
                ops.build_gwc_volume(lb.float(), rb.float(), d, gr).bfloat16(), ref16)
            check(no, f"K3 bf16 {tag}: the unrounded control passes the check")
            control = f"; unrounded control rejected ({c_share:.3g} not bit-equal)"
        if w < d:
            check(not got[:, :, w:].any() and not got16[:, :, w:].any(),
                  "K3: planes with d >= W are not zero")
        print(f"[K3] {tag} {(b, c, h, w, d, gr)}: f32 max-abs {err32:.3g} (tol 1e-5), "
              f"{bits32:.3g} not bit-equal (cap 0 where C/G < {F32_EXACT_CG}), bf16 max-abs "
              f"{err16:.3g} (tol 8e-3·|ref| + 1e-3), {share:.3g} not bit-equal "
              f"(cap {VOLUME_FLIP_SHARE}){control}")
        errs[tag] = (err32, err16, share)
    # G = 1 is K1's function: the two kernels against each other
    left, right = (torch.randn(1, 24, 136, 240, generator=g).to(dev) for _ in range(2))
    err1 = (ops.gwc_volume(left, right, 48, 1)[:, 0] - ops.corr_volume(left, right, 48))
    err1 = err1.abs().max().item()
    check(err1 <= 1e-6, f"K3 with G = 1 vs K1: max-abs {err1} > 1e-6")
    print(f"[K3] G = 1 vs K1 at (1, 24, 136, 240, D 48), f32: max-abs {err1:.3g} (tol 1e-6)")
    for shape, tag in ((FS_K3_SHAPE, "FoundationStereo cosine"),
                       (FFS_K3_SHAPE, "FastFoundationStereo cosine")):
        errs[tag] = cosine_k3_check(dev, shape, g, tag)
    torch.cuda.synchronize()
    return errs


def cosine_k3_check(dev, shape, g, tag):
    """K3 with divisor 1 on the group-normalised features (the kernel route of
    FoundationStereo's cosine volume) against the plain cosine builder
    (`ops.build_cosine_gwc_volume`), f32 (bit-equal: C/G 28, the kernel's sum
    in PyTorch's CUDA order, times 1) and bf16 (`volume_bf16_check` against
    the plain sum on the same normalised bf16 inputs, which is also the plain
    builder's own bf16 result), and the unrounded control (products in f32),
    which must fail that check. Returns (f32 max-abs, bf16 max-abs, share not
    bit-equal)."""
    import torch

    from openstereo_tpu_torch import ops

    b, c, h, w, d, gr, div = shape
    left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
    ref = ops.build_cosine_gwc_volume(left, right, d, gr)
    got = ops.gwc_volume(ops.normalize_groups(left, gr), ops.normalize_groups(right, gr), d, gr,
                         div)
    check(got.shape == (b, gr, d, h, w), f"K3 {tag}: shape {tuple(got.shape)}")
    err32, bits32 = volume_f32_check(got, ref, c // gr, f"K3 f32 {tag} {shape}")
    nl, nr = (ops.normalize_groups(t.bfloat16(), gr) for t in (left, right))
    ref16 = ops.build_gwc_volume(nl, nr, d, gr, div)
    check(torch.equal(ref16, ops.build_cosine_gwc_volume(left.bfloat16(), right.bfloat16(), d,
                                                         gr)), f"K3 bf16 {tag}: plain routes differ")
    got16 = ops.gwc_volume(nl, nr, d, gr, div)
    err16, share = volume_bf16_check(got16, ref16, f"K3 bf16 {tag}")
    no, c_share = volume_rejected(ops.build_gwc_volume(nl.float(), nr.float(), d, gr,
                                                       div).bfloat16(), ref16)
    check(no, f"K3 bf16 {tag}: the unrounded control passes the check")
    print(f"[K3] {tag} {shape} (divisor {div}): f32 max-abs {err32:.3g} (tol 1e-5), {bits32:.3g} "
          f"not bit-equal (cap 0), bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3), {share:.3g} "
          f"not bit-equal (cap {VOLUME_FLIP_SHARE}); unrounded control rejected ({c_share:.3g} "
          f"not bit-equal)")
    return err32, err16, share


def phase_gwcnet(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(GWC_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[gwcnet] GwcNet ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    wired, launches, per_frame = record_path(
        {"gwc_volume": {K3_SHAPE: 1}}, lambda: [run_pair(model, tf, *p) for p in pairs])
    print(f"[record] launches over {N_PAIRS} frames: {launches}; per frame by shape: "
          f"{per_frame}")
    launches, per_frame = launches["gwc_volume"], per_frame["gwc_volume"]

    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    for d in wired + eager:
        check(d.shape == (H, W) and np.isfinite(d).all(), "bf16 disparity not finite [H,W]")
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))
    check(mean16 <= 0.5, f"GwcNet bf16 kernel vs eager mean-abs {mean16} px > 0.5")

    model32 = build_model(cfg.MODEL, dtype=torch.float32, device=dev, seed=0)
    max32 = 0.0
    for p in pairs:
        a = run_pair(set_kernels(model32, True), tf, *p)
        b = run_pair(set_kernels(model32, False), tf, *p)
        max32 = max(max32, float(np.abs(a - b).max()))
    del model32
    torch.cuda.empty_cache()
    print(f"[gwcnet] f32 kernel vs eager: max-abs {max32:.3g} px (tol 5e-3); bf16 kernel vs "
          f"eager: mean-abs {mean16:.3g} px (tol 0.5); bf16 disparity range "
          f"{wired[0].min():.2f}..{wired[0].max():.2f}")
    check(max32 <= 5e-3, f"GwcNet f32 kernel vs eager max-abs {max32} px > 5e-3")
    return model, launches, per_frame, (max32, mean16)


def phase_psmnet(dev):
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.data.transforms import build_transforms
    from openstereo_tpu_torch.models import build_model
    from openstereo_tpu_torch.tools.infer import run_pair

    cfg = load_config(str(PSM_CFG))
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    pairs = list(synthetic_pairs())
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[psmnet] PSMNet ({n_params} parameters), {H}x{W} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: cuDNN plans
    disps, launches, _ = record_path({}, lambda: [run_pair(model, tf, *p) for p in pairs])
    for d in disps:
        check(d.shape == (H, W) and np.isfinite(d).all(), "PSMNet bf16 disparity not finite [H,W]")
    print(f"[psmnet] launches over {N_PAIRS} frames: {launches} (no Pallas "
          f"kernel lies on the JAX PSMNet path, so none of the port's either); bf16 disparity "
          f"finite, {H}x{W}, range {disps[0].min():.2f}..{disps[0].max():.2f}")
    return model


def k3_work(shape, elem):
    b, c, h, w, d, g = shape[:6]
    nbytes = (2 * b * c * h * w + b * g * d * h * w) * elem
    flops = 2 * b * c * h * sum(max(w - k, 0) for k in range(d))  # products with w - d >= 0
    return nbytes, flops


def phase_timing_3d(dev, gwcnet, psmnet, card, per_frame):
    import torch

    from openstereo_tpu_torch.tools.bench import (bench_eager_vs_kernels, pair, profile_paths,
                                                  time_frames)

    res = bench_eager_vs_kernels(gwcnet, groups=4, reps=3)
    for path in ("eager", "kernels"):
        print(f"[time] GwcNet {path}: {res[path]['fps']:.3f} frames/s, "
              f"{res[path]['ms_per_frame']:.3f} ms/frame (median of {len(res[path]['group_ms'])} "
              f"groups of 3 chained frames)")
    psm_ms = time_frames(psmnet, pair(dev), groups=4, reps=3)
    psm = {"ms_per_frame": float(np.median(psm_ms)), "group_ms": [float(t) for t in psm_ms]}
    psm["fps"] = 1000.0 / psm["ms_per_frame"]
    print(f"[time] PSMNet: {psm['fps']:.3f} frames/s, {psm['ms_per_frame']:.3f} ms/frame "
          f"(median of 4 groups of 3 chained frames)")
    prof = profile_paths(gwcnet, 2, str(OUT_DIR / "gwcnet_profile"))
    psm_prof = profile_paths(psmnet, 2, str(OUT_DIR / "psmnet_profile"), paths=("eager",))
    rows = [("GwcNet", path, r, res[path]["ms_per_frame"]) for path, r in prof.items()]
    rows.append(("PSMNet", "eager", psm_prof["eager"], psm["ms_per_frame"]))
    for name, path, r, ms in rows:
        r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / ms
        top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                        for t in r["top"][:8])
        print(f"[profile] {name} {path}: device busy {r['device_busy_ms_per_frame']:.3f} "
              f"ms/frame, idle share {r['idle_share']:.4f} (against {ms:.3f} ms/frame "
              f"untraced); top: {top}")

    k3 = k3_timing(dev, per_frame, card, torch.Generator().manual_seed(7))
    return res, psm, prof, k3


def k3_timing(dev, per_frame, card, g, tag="K3"):
    return volume_timing(dev, per_frame, card, g, tag, grouped=True)


def model_paths():
    """The CoEx, MSNet3D, MSNet2D, CFNet, FADNet, CasGwcNet and CasPSMNet
    paths: (name, config, the kernels each must launch per frame by shape,
    the f32 rule: the module whose output feeds a top-k head, "share" for a
    model whose sample grids are floors (CFNet: ≥ 99.9 % of the pixels within
    5e-3 px, as a floor may move one sample by a disparity at a pixel) or
    None for max-abs 5e-3 px, the timing protocol). CoEx's top-k head picks 2
    of its 48 costs; with random weights the costs are nearly flat, so a bf16
    rounding moves the picks and the bf16 disparity of either path lies ~11 px from the f32
    one (the phase prints both; the flax model's own bf16 lies as far from
    its f32, `tests/coex_bf16_witness.py`): its bf16 check holds the cost
    that feeds the head, and the kernel path's distance from the f32
    disparity against the eager path's. Its f32 check is a share of pixels,
    as near-ties may flip there too (as STTR's argmax may). The protocol:
    (timing groups, chained frames per group, frames profiled), about 0.25-1
    s per group, as LightStereo-S's groups of 20; 2 groups a path (one in each of
    the bench's two turns; 4 and 5-10 profiled frames before phases 46-47 were
    added, cut for the script's time)."""
    return [
        ("CoEx", COEX_CFG, {"corr_volume": {COEX_K1_SHAPE: 1}, "fused_mbconv": COEX_K2_SHAPES},
         "CostProcessor.cost_agg", (2, 20, 3)),
        ("MSNet3D", MSNET3D_CFG, {"gwc_volume": {K3_SHAPE: 1}, "fused_mbconv": MSNET3D_K2_SHAPES},
         None, (2, 12, 3)),
        ("MSNet2D", MSNET2D_CFG, {"fused_mbconv": MSNET2D_K2_SHAPES}, None, (2, 20, 3)),
        ("CFNet", CFNET_CFG, {"gwc_volume": CFNET_K3_SHAPES}, "share", (2, 5, 3)),
        ("FADNet", FADNET_CFG, {"corr_volume": {FADNET_K1_SHAPE: 1}}, None, (2, 10, 3)),
        ("CasGwcNet", CASGWC_CFG, {}, None, (2, 6, 3)),
        ("CasPSMNet", CASPSM_CFG, {}, None, (2, 6, 3)),
    ]


def phase_model(dev, name, cfg_file, want, rule):
    """One of the paths of `model_paths` at its config's EVALUATING size, b1,
    bf16, random weights (seed 0), through `run_pair` on the synthetic
    pairs: the launch records, peak memory, and the kernel path against the
    eager path. f32 (TF32 off, on the first F32_PAIRS pairs): max-abs <= 5e-3
    px (`rule` None, or "deterministic" under cuDNN's deterministic
    algorithms), or (`rule` "share" or a top-k head) >= 99.9 % of the pixels
    within 5e-3 px. bf16: mean-abs <=
    0.5 px; with a top-k head (`rule`, the module whose output feeds it),
    that cost within one bf16 unit of its largest magnitude on average, and
    the kernel path's disparity no more than 5 % further from the f32 eager
    one than the eager path's is (`model_paths` says why). Each bf16 path's
    distance from the f32 eager disparity is printed for every model."""
    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.models import build_model, set_kernels
    from openstereo_tpu_torch.tools.bench import eval_size
    from openstereo_tpu_torch.tools.infer import run_pair

    tag = f"[{name.lower()}]"
    cfg = load_config(str(cfg_file))
    size = eval_size(cfg)
    topk_input = rule if rule not in (None, "share", "deterministic") else None
    tf = eval_transforms(cfg)
    pairs = list(synthetic_pairs(size))
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag} {name} ({n_params} parameters), {size[0]}x{size[1]} b1 bf16, {N_PAIRS} pairs")
    run_pair(model, tf, *pairs[0])  # warm-up: kernel build and cuDNN plans
    costs = {"kernels": [], "eager": []}
    if topk_input:
        hook = model.get_submodule(topk_input).register_forward_hook(
            lambda mod, inp, out: costs[path].append(out.float()))
    path = "kernels"
    torch.cuda.reset_peak_memory_stats(dev)
    wired, launches, per_frame = record_path(want, lambda: [run_pair(model, tf, *p)
                                                            for p in pairs])
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{tag} launches over {N_PAIRS} frames: {launches}; per frame by shape: {per_frame}; "
          f"peak memory (max_memory_allocated) {peak / 2**30:.3f} GiB")
    path = "eager"
    set_kernels(model, False)
    eager = [run_pair(model, tf, *p) for p in pairs]
    set_kernels(model, True)
    if topk_input:
        hook.remove()
    for d in wired + eager:
        check(d.shape == size and np.isfinite(d).all(),
              f"{name} bf16 disparity not finite {list(size)}")
    mean16 = max(float(np.abs(a - b).mean()) for a, b in zip(wired, eager))

    # the same weights in f32 compute: the parameters are f32 in either dtype, and building
    # FoundationStereo's 372M of them again took ~10 s of the host
    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    max32, share32, eager32 = 0.0, 1.0, []
    # the "share" rule's models (CFNet's floored sample grids, IGEV's 32 GRU iterations) carry a
    # rounding far: both paths run cuDNN's deterministic algorithms, so that two eager runs are
    # bit-equal and what differs is the kernels' (`zoo_eval` says why); "deterministic" does the
    # same under the max-abs rule
    t32 = time.perf_counter()
    with cudnn_deterministic(rule in ("share", "deterministic")):
        for p in pairs[:F32_PAIRS]:
            a = run_pair(set_kernels(model32, True), tf, *p)
            eager32.append(run_pair(set_kernels(model32, False), tf, *p))
            d = np.abs(a - eager32[-1])
            max32, share32 = max(max32, float(d.max())), min(share32, float((d <= 5e-3).mean()))
    set_kernels(model32, True)
    del model32
    torch.cuda.empty_cache()
    to_f32 = {k: max(float(np.abs(a - b).mean()) for a, b in zip(ds, eager32))
              for k, ds in (("kernels", wired), ("eager", eager))}
    max_abs_rule = rule in (None, "deterministic")
    t32 = time.perf_counter() - t32
    print(f"{tag} f32 kernel vs eager on {F32_PAIRS} pair(s) ({t32:.1f} s): max-abs {max32:.3g} px, "
          f"share within 5e-3 px "
          f"{share32:.6f} (tol {'max-abs 5e-3' if max_abs_rule else '>= 0.999'}); bf16 kernel vs "
          f"eager: mean-abs {mean16:.4g} px (tol {'-' if topk_input else '0.5'}); bf16 vs the f32 "
          f"eager disparity, mean-abs: kernels {to_f32['kernels']:.4g} px, eager "
          f"{to_f32['eager']:.4g} px; bf16 disparity range {wired[0].min():.2f}.."
          f"{wired[0].max():.2f}")
    rec = {"size": list(size), "launches": launches, "per_frame": per_frame, "peak_bytes": peak,
           "max_abs_f32": max32, "share_within_5e-3_f32": share32, "mean_abs_bf16": mean16,
           "mean_abs_bf16_to_f32": to_f32}
    if not max_abs_rule:
        check(share32 >= 0.999, f"{name} f32 kernel vs eager: only {share32} of pixels within "
                                f"5e-3 px")
    else:
        check(max32 <= 5e-3, f"{name} f32 kernel vs eager max-abs {max32} px > 5e-3")
    if topk_input:
        cost = max(float((a - b).abs().mean() / b.abs().max())
                   for a, b in zip(costs["kernels"], costs["eager"]))
        print(f"{tag} bf16 kernel vs eager, the cost feeding the top-k head ({topk_input}): "
              f"mean-abs {cost:.3g} of its largest magnitude (tol 2^-7 = {2 ** -7:.3g})")
        check(cost <= 2 ** -7, f"{name} bf16 top-k input: mean-abs {cost}·max|cost| > 2^-7")
        check(to_f32["kernels"] <= 1.05 * to_f32["eager"],
              f"{name} bf16 kernel path {to_f32['kernels']} px from the f32 disparity, the eager "
              f"path {to_f32['eager']} px: more than 5 % further")
        rec["topk_input_mean_abs_rel_bf16"] = cost
    else:
        check(mean16 <= 0.5, f"{name} bf16 kernel vs eager mean-abs {mean16} px > 0.5")
    return model, rec


def eval_transforms(cfg):
    """A config's EVALUATING transforms. FoundationStereo's config has none (the
    JAX infer CLI raises on it, as the port's does): its pairs, made at
    544x960, go through the TRAINING list's NormalizeImage alone, the
    ImageNet normalisation the model expects."""
    from openstereo_tpu_torch.data.transforms import build_transforms

    lists = cfg.DATA_CONFIG.DATA_TRANSFORM
    if "EVALUATING" in lists:
        return build_transforms(lists["EVALUATING"])
    return build_transforms([t for t in lists["TRAINING"] if t["NAME"] == "NormalizeImage"])


def phase_timing_model(dev, name, model, card, per_frame, protocol, size=(H, W)):
    """Each kernel of the path at its shapes beside its plain version and its
    bound (first: its device-time trace is short, and one run's trace of a
    kernel right after a long model profile recorded no launch three times),
    frames/s of both paths (the bench protocol: `groups` groups of `reps`
    chained frames, with the spread between groups and the host's issue time
    per frame) and a torch.profiler pass over `frames` frames of the kernel
    path (its table in `chiprun_out/<name>_profile/`; the eager path's pass
    was cut for the script's time when phases 46-47 were added)."""
    import torch

    from openstereo_tpu_torch.tools.bench import bench_eager_vs_kernels, profile_paths

    g = torch.Generator().manual_seed(9)
    timing = {"corr_volume": k1_timing, "fused_mbconv": k2_timing, "gwc_volume": k3_timing}
    kernel_times = {k: timing[k](dev, shapes, card, g, tag=f"{k} ({name})")
                    for k, shapes in per_frame.items()}
    groups, reps, frames = protocol
    res = bench_eager_vs_kernels(model, groups=groups, reps=reps, size=size)
    prof = profile_paths(model, frames, str(OUT_DIR / f"{name.lower()}_profile"), size=size,
                         paths=("kernels",))
    for path in ("eager", "kernels"):
        b = res[path]
        print(f"[time] {name} {path}: {b['fps']:.3f} frames/s, {b['ms_per_frame']:.3f} ms/frame "
              f"(median of {len(b['group_ms'])} groups of {reps} chained frames; groups "
              f"{min(b['group_ms']):.3f}..{max(b['group_ms']):.3f} ms, spread "
              f"{b['group_spread']:.1%}); host issue {b['host_issue_ms']:.3f} ms/frame")
    r = prof["kernels"]
    r["idle_share"] = 1.0 - r["device_busy_ms_per_frame"] / res["kernels"]["ms_per_frame"]
    top = "; ".join(f"{t['kernel'][:60]} {t['ms_per_frame']:.3f} ms x{t['calls_per_frame']:g}"
                    for t in r["top"][:8])
    print(f"[profile] {name} kernels: device busy {r['device_busy_ms_per_frame']:.3f} ms/frame "
          f"over {frames} frames, {r['device_ops_per_frame']:g} device operations a frame, idle "
          f"share {r['idle_share']:.4f}; top: {top}")
    return res, prof, kernel_times


def phase_eval_batch(dev):
    """K1 and K2 at the shapes the trainer's evaluation launches them at
    (batch 12; K2 at 24 in the siamese trunk), f32 (TF32 off) and bf16, with
    the checks of phases 3 and 4 and the launcher's split count per shape."""
    import torch

    g = torch.Generator().manual_seed(8)
    k1 = check_volume_kernel(dev, "corr_volume", K1_EVAL_SHAPE, g, "[eval-batch] K1")
    worst32, worst16, splits_by_shape = check_k2_shapes(dev, K2_EVAL_SHAPES, g, "[eval-batch]")
    print(f"[eval-batch] K2 launcher split counts: {splits_by_shape}")
    return k1, (worst32, worst16), splits_by_shape


WRITERS = []  # the process pool of `write_pairs` (`start_writers`); `main` stops it


def warm_writer(_):
    """What a writer of `write_pairs` imports (`start_writers`)."""
    import PIL.Image  # noqa: F401

    import openstereo_tpu_torch.data.readers  # noqa: F401
    import openstereo_tpu_torch.tools.overfit_check  # noqa: F401


def start_writers():
    """Starts the 8 worker processes of `write_pairs` (spawned: this process
    holds the card) and their imports, without waiting for them: the first
    set then finds them ready (their start took ~8 s of phase 37's time)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn"))
    WRITERS.append(pool)
    for i in range(8):
        pool.submit(warm_writer, i)


def write_pairs(one, indices):
    """`one(i)` for each of `indices` in the 8 worker processes of
    `start_writers` (the stereogram's row loop holds the interpreter lock,
    which made 8 threads little faster than one): their results, in order."""
    if not WRITERS:
        start_writers()
    return list(WRITERS[0].map(one, indices))


def save_png(img, path):
    """An image as PNG at zlib level 1 (random dots barely compress; level 6
    took most of a pair's writing time)."""
    from PIL import Image

    Image.fromarray(img).save(path, compress_level=1)


def stereo_pair(root, hw, max_disp, i):
    """Random-dot stereogram `i` (`write_stereo_set`)."""
    from openstereo_tpu_torch.data.readers import write_pfm
    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
    for sub, img in (("left", left), ("right", right)):
        save_png(np.clip(np.round(img), 0, 255).astype(np.uint8), root / sub / f"{i:04d}.png")
    write_pfm(str(root / "left" / f"{i:04d}.pfm"), disp)
    return f"left/{i:04d}.png right/{i:04d}.png left/{i:04d}.pfm"


def write_stereo_set(root, n, first, hw, max_disp):
    """`n` random-dot stereograms (the port's `make_stereogram`, seeds
    first..first+n-1) in the SceneFlow layout: left/, right/ PNG and left/
    PFM disparities; returns the split lines."""
    import functools

    for sub in ("left", "right"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    return write_pairs(functools.partial(stereo_pair, root, hw, max_disp),
                       range(first, first + n))


SET_LINES = []  # the split lines of `sceneflow_set`, once written


def sceneflow_set():
    """The random-dot SceneFlow-layout set of phases 14 and 26-51 under
    `chiprun_out/`, written the first time (TRAIN_PAIRS + EVAL_PAIRS pairs at
    PAIR_HW, max_disp 192, seeds from 0; `main` deletes it): (root, its split
    lines)."""
    import shutil

    root = SET_DIR / "SceneFlow"
    if not SET_LINES:
        shutil.rmtree(SET_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        SET_LINES.extend(write_stereo_set(root, TRAIN_PAIRS + EVAL_PAIRS, 0, PAIR_HW, 192))
        print(f"[sceneflow-set] wrote {len(SET_LINES)} random-dot pairs at {PAIR_HW[0]}x"
              f"{PAIR_HW[1]} (PNG, PFM) in {time.perf_counter() - t0:.1f} s")
    return root, list(SET_LINES)


def phase_train(dev):
    """`run_training` on `sceneflow_set`; the run's checkpoints are deleted
    afterwards (its log, metrics and config stay)."""
    import shutil

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    try:
        return run_training(dev, *sceneflow_set())
    finally:
        for ckpt in TRAIN_DIR.glob("runs/**/ckpt"):
            shutil.rmtree(ckpt, ignore_errors=True)


def run_training(dev, data_root, lines):
    """The port's training entry point (`tools/train.py`) on the LightStereo-S
    SceneFlow config at full width: crop 320x736, batch 24, AMP bf16, AdamW
    2.4e-3, OneCycleLR, clip by value 0.1. Cuts: NUM_EPOCHS 1 (4 steps) and
    a synthetic data set. Its evaluation (544x960, batch 12) must go
    through K1 and K2; then the same weights evaluated eager, and a resumed
    Trainer against the checkpoint."""
    import torch
    import yaml

    from openstereo_tpu_torch.config import Config
    from openstereo_tpu_torch.models import set_kernels
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.runtime import Trainer
    from openstereo_tpu_torch.tools import train

    split = {}
    for mode, part in (("train", lines[:TRAIN_PAIRS]), ("test", lines[TRAIN_PAIRS:])):
        split[mode] = TRAIN_DIR / f"sceneflow_{mode}.txt"
        split[mode].write_text("\n".join(part))

    cfg = yaml.safe_load(CFG_FILE.read_text())
    info = cfg["DATA_CONFIG"]["DATA_INFOS"][0]
    info["DATA_SPLIT"] = {"TRAINING": str(split["train"]), "EVALUATING": str(split["test"]),
                          "TESTING": str(split["test"])}
    info["DATA_PATH"] = str(data_root)
    cfg["OPTIMIZATION"]["NUM_EPOCHS"] = 1  # the cut: 96 pairs / 24 = 4 steps
    cfg_file = TRAIN_DIR / "lightstereo_s_sceneflow.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    paths = TRAIN_DIR / "data_paths.yaml"
    paths.write_text(yaml.safe_dump({info["DATASET"]: str(data_root)}))
    opt = cfg["OPTIMIZATION"]
    print(f"[train] config: crop {cfg['DATA_CONFIG']['DATA_TRANSFORM']['TRAINING'][0]['SIZE']}, "
          f"batch {opt['BATCH_SIZE_PER_GPU']}, AMP {opt['AMP']}, {opt['OPTIMIZER']['NAME']} "
          f"{opt['OPTIMIZER']['LR']}, {opt['SCHEDULER']['NAME']}, clip {opt['CLIP_GRAD']}, "
          f"NUM_EPOCHS {opt['NUM_EPOCHS']}; evaluation batch {cfg['EVALUATOR']['BATCH_SIZE_PER_GPU']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train.main(["--cfg_file", str(cfg_file), "--save_root", str(TRAIN_DIR / "runs"),
                          "--data_paths", str(paths), "--workers", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    shapes = {k: dict(v) for k, v in kernels.launch_shapes.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_eval = trainer.eval_loader.steps_per_epoch
    steps = trainer.state.step
    check(steps == TRAIN_PAIRS // opt["BATCH_SIZE_PER_GPU"], f"{steps} train steps")
    losses, step_ms = trainer.epoch_losses, trainer.epoch_step_ms
    check(len(losses) == steps and all(np.isfinite(v) for v in losses), f"losses {losses}")
    print(f"[train] launches over the run ({steps} train steps, {n_eval} evaluation batch(es)): "
          f"{launches}")
    check(launches["corr_volume"] == n_eval and launches["fused_mbconv"] == 18 * n_eval,
          f"launches {launches} != K1 1 and K2 18 per evaluation batch (and none in training)")
    check(launches["rel_attention"] == 0 and launches["gwc_volume"] == 0, f"launches {launches}")
    check(shapes["corr_volume"] == {K1_EVAL_SHAPE: n_eval},
          f"K1 launch shapes {shapes['corr_volume']}")
    check(shapes["fused_mbconv"] == {k: n * n_eval for k, n in K2_EVAL_SHAPES.items()},
          f"K2 launch shapes {shapes['fused_mbconv']} != {K2_EVAL_SHAPES} per batch")
    ms = float(np.median(step_ms[1:4]))
    rate = opt["BATCH_SIZE_PER_GPU"] / ms * 1e3
    records = [json.loads(ln) for ln in open(trainer.metrics_file)]
    wired = [r for r in records if r["phase"] == "eval"][-1]
    print(f"[train] losses {[round(v, 4) for v in losses]}; step ms (CUDA events) "
          f"{[round(t, 2) for t in step_ms]}; median of steps 2-4 {ms:.2f} ms/step, "
          f"{rate:.1f} samples/s; peak memory (max_memory_allocated) {peak / 2**30:.3f} GiB; "
          f"run wall time {wall:.1f} s")

    set_kernels(trainer.model, False)
    kernels.reset_launch_counts()
    eager = trainer.evaluate(0)
    check(sum(kernels.launch_counts.values()) == 0, "the eager evaluation launched kernels")
    set_kernels(trainer.model, True)
    d_epe = abs(wired["epe"] - eager["epe"])
    print(f"[train] evaluation with kernels: "
          f"{ {k: round(v, 4) for k, v in wired.items() if k not in ('phase', 'epoch')} }; "
          f"eager: { {k: round(v, 4) for k, v in eager.items()} }; |EPE difference| "
          f"{d_epe:.4g} px (tol 0.5)")
    check(all(np.isfinite(v) for k, v in wired.items() if k not in ("phase",)), f"{wired}")
    check(d_epe <= 0.5, f"evaluation with kernels vs eager: EPE differs by {d_epe} px > 0.5")

    check(trainer.saved_epochs() == [0], f"checkpoints {trainer.saved_epochs()}")
    saved = torch.load(trainer.ckpt_path(0), map_location="cpu", weights_only=True)
    again = Trainer(Config.from_dict(cfg), trainer.run_dir, device=dev, num_workers=8)
    start = again.resume_ckpt()
    state = again.model.state_dict()
    same = all(torch.equal(state[k].cpu(), v) for k, v in saved["model_state"].items())
    check(start == 1 and again.start_epoch == 1 and again.state.step == steps and same,
          f"resume: start epoch {start}, step {again.state.step}, bit-equal {same}")
    print(f"[train] resumed Trainer: start epoch {start}, step {again.state.step}, "
          f"{len(saved['model_state'])} tensors bit-equal to the checkpoint")
    prof = profile_train_steps(again, ms)
    del trainer, again
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "samples_per_s": rate, "step_ms": step_ms, "losses": losses,
            "peak_bytes": peak, "eval_kernels": wired, "eval_eager": eager, "launches": launches,
            "eval_batches": n_eval, "profile": prof}


def profile_train_steps(trainer, untraced_ms, batch=None, steps=1, label="b24 320x736 bf16",
                        table=TRAIN_DIR / "profile_train_step.txt"):
    """torch.profiler over `steps` train steps of `trainer` on `batch`, the
    device's activity only: device busy ms per step (the kernel rows summed;
    one stream), its idle share against `untraced_ms` per step, and the top
    kernels (the 40 largest rows in `table`). Without `batch`, one batch of
    its loader and a warm-up step outside the trace; a caller that passes
    `batch` has just run steps on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from openstereo_tpu_torch.data.loader import batch_to_device
    from openstereo_tpu_torch.tools.bench import device_rows, write_rows

    if batch is None:
        batches = trainer.train_loader.epoch(1)
        batch = batch_to_device(next(batches), trainer.device)
        batches.close()
        trainer.train_step(batch)  # warm-up outside the trace
    torch.cuda.synchronize()
    # the device's activity only: tracing the host's too takes longer than the step itself at
    # ~20,000 launches a step, for the same device busy time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0) / steps
    rows = device_rows(prof)
    busy = sum(ms for _, _, ms in rows) / steps
    write_rows(rows, str(table), steps, "step")
    top = [{"kernel": k[:90], "ms_per_step": ms / steps, "calls_per_step": n / steps}
           for k, n, ms in rows[:10]]
    idle = 1.0 - busy / untraced_ms
    print(f"[profile] train step ({label}): device busy {busy:.2f} ms/step, idle share "
          f"{idle:.4f} (against {untraced_ms:.2f} ms/step untraced; {1.0 - busy / traced:.4f} "
          f"against the traced steps' {traced:.2f} ms/step); top: " + "; ".join(
              f"{t['kernel'][:60]} {t['ms_per_step']:.2f} ms x{t['calls_per_step']:g}"
              for t in top[:8]))
    return {"device_busy_ms_per_step": busy, "idle_share": idle, "traced_ms_per_step": traced,
            "idle_share_traced": 1.0 - busy / traced, "top": top}


def in_worker(fn, *args):
    """`fn(*args)` in a worker process of `start_beside_build`, with this
    script's f32 settings (TF32 off) and one host thread (eight workers share
    the host's cores with the build): (its result, or None and the check it
    failed, the lines it printed, its seconds)."""
    import contextlib
    import io

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    log, res, failure = io.StringIO(), None, None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        try:
            res = fn(*args)
        except SmokeFailure as e:
            failure = str(e)
    return res, failure, log.getvalue(), time.perf_counter() - t0


def overfit_run(args):
    """`tools/overfit_check.py` with `args`: its result, with the port's kernel
    launches it made."""
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.tools import overfit_check

    res = overfit_check.main(args)
    res["launches"] = dict(kernels.launch_counts)
    return res


def grad_checks(names):
    """`zoo_grad_check` of the paths of `zoo_train_paths` named `names`, by name."""
    import torch

    paths = {p.name: p for p in zoo_train_paths()}
    return {name: zoo_grad_check(torch.device("cuda"), paths[name]) for name in names}


def start_beside_build():
    """Starts the checks that launch no kernel of the port, without waiting
    for them: the learning checks of OVERFITS, one spawned worker process
    each (this process holds the card), and the gradient checks of
    `zoo_train_paths` in GRAD_WORKERS more. Returns the pool and their
    futures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    names = [p.name for p in zoo_train_paths()]
    pool = ProcessPoolExecutor(len(OVERFITS) + GRAD_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    return pool, ([pool.submit(in_worker, overfit_run, args) for _, _, args in OVERFITS],
                  [pool.submit(in_worker, grad_checks, names[i::GRAD_WORKERS])
                   for i in range(GRAD_WORKERS)])


def phase_beside_build(futures):
    """The results of `start_beside_build`. The learning checks of OVERFITS,
    each reported as its phase: the lines it printed, no kernel launched and
    its rule. LightStereo (phase 15: 40 steps, 192x384, batch 4, max_disp
    64, bf16, AdamW 4e-4, clip by value 0.1): the final train EPE below 3 px
    (the JAX tool's CONVERGED line). The others, the mean loss of the last 20
    steps below 0.8 of the first 5 steps': GwcNet (phase 30: 40 steps on one
    batch of 2 at 192x384, max_disp 64, f32, RMSprop 1e-4 constant, clip by
    norm 35), FADNet (phase 35: 40 steps of b1, f32, Lamb 4e-3 constant, no
    clip), IGEV (phase 45: 40 steps of b2, bf16, AdamW 2e-4 constant, clip by
    norm 35, 22 GRU iterations) and FastFoundationStereo (phase 52: 40 steps
    of b1, bf16, AdamW 2e-4 constant, clip by norm 1, 12 GRU iterations).
    Then the gradient checks' lines and checks. Returns (the learning
    checks' results by model, the gradient checks' by path)."""
    learned, grads = {}, {}
    for (label, name, _), fut in zip(OVERFITS, futures[0]):
        res, failure, log, took = fut.result()
        sys.stdout.write(log)
        check(failure is None, failure)
        traj = [(s, round(l, 4), round(e, 3)) for s, l, e in res["trajectory"]]
        print(f"[overfit] {name} trajectory (step, loss, train EPE px): {traj}; final train EPE "
              f"{res['final_epe']:.3f} px, loss ratio (last 20 / first 5) "
              f"{res['loss_ratio']:.4f} (tol {'EPE < 3 px' if name == 'LightStereo' else '< 0.8'})"
              f"; kernel launches {res['launches']}; {took:.1f} s")
        check(sum(res["launches"].values()) == 0,
              f"{name} overfit check launched kernels: {res['launches']}")
        if name == "LightStereo":
            check(res["final_epe"] < 3.0,
                  f"overfit check: final train EPE {res['final_epe']} px >= 3.0")
        else:
            check(res["loss_ratio"] < 0.8,
                  f"{name} overfit check: loss ratio {res['loss_ratio']} >= 0.8")
        res["seconds"] = PHASE_SECONDS[f"{label}, beside the build"] = took
        print(f"[phase-time] {label}: {took:.1f} s (beside the build)")
        learned[name] = res
    for i, fut in enumerate(futures[1]):
        res, failure, log, took = fut.result()
        sys.stdout.write(log)
        check(failure is None, failure)
        PHASE_SECONDS[f"26-51 gradient checks {i + 1}/{GRAD_WORKERS}, beside the build"] = took
        print(f"[phase-time] 26-51 gradient checks of {', '.join(res)}: {took:.1f} s (beside the "
              f"build)")
        grads.update(res)
    return learned, grads


def bound_f32(nbytes, flops, card):
    """As `bound`, against the f32 peak outside the tensor cores (TF32 is off)."""
    t_bytes, t_ops = nbytes / card[0] * 1e3, flops / card[2] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k4_backward_work(shape):
    """f32 bytes and flops of K4's backward (`rel_attention_backward`): it reads
    q, k, v, dout, both tables (and draw) once and writes the five gradients;
    per line 5 W x W products (the recomputed q.k^T, dv, dp, dq, dk) and 6
    products with the 2W-1 tables, each 2 flops a multiply-add."""
    b, w, e, _, _, need_raw = shape
    r = 2 * w - 1
    nbytes = 4 * (7 * b * w * e + 4 * r * e + (b * w * w if need_raw else 0))
    return nbytes, b * (10 * w * w * e + 12 * w * r * e)


def k4_train_grads(fn, args, nh, masked, need_raw, d_out, d_raw):
    """Outputs and the five input gradients of `fn` (the trainable K4 or the
    plain version) under autograd, for the cotangents d_out (and d_raw)."""
    import torch

    leaves = [a.clone().requires_grad_(True) for a in args]
    out, raw = fn(*leaves, nh, masked, need_raw)
    outs, cots = ([out, raw], [d_out, d_raw]) if need_raw else ([out], [d_out])
    grads = torch.autograd.grad(outs, leaves, cots)
    return [o.detach() for o in outs], list(grads)


def k4_train_close(got, ref):
    """|got - ref| <= 2e-4 + 1e-4·|ref| (the JAX package's gradient test) at
    every element, the masked raw entries (< -1e29 in both) left out."""
    fin = ref.abs() < 1e20
    if not bool((got[~fin] < -1e29).all()):
        return False
    return bool(((got[fin] - ref[fin]).abs() <= 2e-4 + 1e-4 * ref[fin].abs()).all())


@contextmanager
def shifted_unskew():
    """K4's backward with its `_unskew` shifted by one column: the control that
    phases 23 and 24 must reject."""
    k4mod = importlib.import_module("openstereo_tpu_torch.ops.rel_attention")
    real = k4mod._unskew
    k4mod._unskew = lambda da, w_: real(da, w_).roll(1, dims=-1)
    try:
        yield
    finally:
        k4mod._unskew = real


def phase_k4_train(dev, card):
    """K4 under autograd at the three training shapes, f32 (TF32 off): the
    trainable Function (K4's forward, the PyTorch backward) against autograd
    through the plain version, out, raw and the five gradients for random
    cotangents; a control whose `_unskew` is shifted by one column must fail
    the same check. Times (CUDA events): K4's forward, the backward alone,
    the Function's forward + backward, the plain version's and the eager
    einsum path's forward + backward, and the bounds of the forward and the
    backward at f32 rates."""
    import importlib

    import torch

    from openstereo_tpu_torch.models.sttr.transformer import rel_attention_eager
    from openstereo_tpu_torch.ops import kernels

    k4mod = importlib.import_module("openstereo_tpu_torch.ops.rel_attention")
    g = torch.Generator().manual_seed(23)
    res = {"shapes": [], "max_abs_err": 0.0, "max_grad_err": 0.0, "control": {}}
    for key in ("ms", "plain_ms", "bound_ms", "backward_ms", "backward_bound_ms", "fwd_bwd_ms",
                "plain_fwd_bwd_ms", "yardstick_fwd_bwd_ms"):
        res[key] = 0.0
    t_bytes = t_ops = 0.0
    for shape, count in sorted(K4_TRAIN_SHAPES.items(), reverse=True):
        b, w, e, nh, masked, need_raw = shape
        args = k4_inputs(shape, dev, g)
        d_out = torch.randn(b, w, e, generator=g).to(dev)
        d_raw = torch.randn(b, w, w, generator=g).to(dev) if need_raw else None
        _, exact = k4_train_grads(k4mod.rel_attention_plain, [a.double() for a in args], nh,
                                  masked, need_raw, d_out.double(),
                                  None if d_raw is None else d_raw.double())
        kernels.reset_launch_counts()
        outs, grads = k4_train_grads(k4mod.rel_attention_trainable, args, nh, masked, need_raw,
                                     d_out, d_raw)
        torch.cuda.synchronize()
        check(kernels.launch_counts["rel_attention"] == 1,
              f"K4-train {shape}: {kernels.launch_counts} launches for one forward + backward")
        ref_outs, ref_grads = k4_train_grads(k4mod.rel_attention_plain, args, nh, masked,
                                             need_raw, d_out, d_raw)
        errs = {}
        for name, a, r in zip(("out", "raw")[:len(outs)] + ("dq", "dk", "dv", "dke", "dqe"),
                              outs + grads, ref_outs + ref_grads):
            fin = r.abs() < 1e20
            errs[name] = (a[fin] - r[fin]).abs().max().item()
            check(k4_train_close(a, r), f"K4-train {shape} {name}: max-abs {errs[name]} beyond "
                                        f"atol 2e-4, rtol 1e-4 of autograd through the plain version")
        # against the exact gradient (autograd through the plain version in f64), for scale
        vs64 = {n: ((a.double() - r).abs().max() / r.abs().max()).item()
                for n, a, r in zip(("dq", "dk", "dv", "dke", "dqe"), grads, exact)}
        vs64_plain = {n: ((a.double() - r).abs().max() / r.abs().max()).item()
                      for n, a, r in zip(("dq", "dk", "dv", "dke", "dqe"), ref_grads, exact)}
        res["max_abs_err"] = max(res["max_abs_err"], errs["out"])
        res["max_grad_err"] = max(res["max_grad_err"], *(errs[n] for n in ("dq", "dk", "dv",
                                                                            "dke", "dqe")))
        with shifted_unskew():
            _, bad = k4_train_grads(k4mod.rel_attention_trainable, args, nh, masked, need_raw,
                                    d_out, d_raw)
        caught = [n for n, a, r in zip(("dq", "dk", "dv", "dke", "dqe"), bad, ref_grads)
                  if not k4_train_close(a, r)]
        check(bool(caught), f"K4-train {shape}: the control with _unskew shifted by one column "
                            "passes the check")
        res["control"][str(shape)] = caught
        del outs, grads, ref_outs, ref_grads, bad, exact

        fwd = lambda: k4mod.rel_attention(*args, nh, masked, need_raw)  # noqa: E731
        t_f = time_ms(fwd, iters=10, warmup=2)
        t_pf = time_ms(lambda: k4mod.rel_attention_plain(*args, nh, masked, need_raw), iters=3,
                       warmup=1)
        t_b = time_ms(lambda: k4mod.rel_attention_backward(*args, d_out, d_raw, nh, masked),
                      iters=5, warmup=1)
        t_fb = time_ms(lambda: k4_train_grads(k4mod.rel_attention_trainable, args, nh, masked,
                                              need_raw, d_out, d_raw), iters=5, warmup=1)
        t_pfb = time_ms(lambda: k4_train_grads(k4mod.rel_attention_plain, args, nh, masked,
                                               need_raw, d_out, d_raw), iters=3, warmup=1)
        t_yfb = time_ms(lambda: k4_train_grads(
            lambda *a: rel_attention_eager(*a[:6], masked=a[6]), args, nh, masked, need_raw,
            d_out, d_raw), iters=3, warmup=1)
        fb, ff, _ = k4_work(shape, 4)
        t_bound, by = bound_f32(fb, ff, card)
        bb, bf = k4_backward_work(shape)
        t_bbound, bby = bound_f32(bb, bf, card)
        t_bytes += count * fb / card[0] * 1e3
        t_ops += count * ff / card[2] * 1e3
        for key, t in (("ms", t_f), ("plain_ms", t_pf), ("bound_ms", t_bound),
                       ("backward_ms", t_b), ("backward_bound_ms", t_bbound),
                       ("fwd_bwd_ms", t_fb), ("plain_fwd_bwd_ms", t_pfb),
                       ("yardstick_fwd_bwd_ms", t_yfb)):
            res[key] += count * t
        res["shapes"].append({"shape": list(shape), "launches_per_step": count, "ms": t_f,
                              "plain_ms": t_pf, "bound_ms": t_bound, "bound_by": by,
                              "backward_ms": t_b, "backward_bound_ms": t_bbound,
                              "backward_bound_by": bby, "fwd_bwd_ms": t_fb,
                              "plain_fwd_bwd_ms": t_pfb, "yardstick_fwd_bwd_ms": t_yfb,
                              "bytes": fb, "flops": ff, "backward_bytes": bb,
                              "backward_flops": bf, "errors": errs, "control_caught": caught,
                              "grad_err_vs_f64": vs64, "plain_grad_err_vs_f64": vs64_plain})
        print(f"[K4-train] {shape} x{count} f32: errors vs autograd through the plain version "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol 2e-4 + 1e-4·|ref|); "
              f"against the f64 gradient, per max|g|: Function "
              f"{ {k: float(f'{v:.3g}') for k, v in vs64.items()} }, plain version in f32 "
              f"{ {k: float(f'{v:.3g}') for k, v in vs64_plain.items()} }; "
              f"shifted-_unskew control caught in {caught}; K4 forward {t_f:.4f} ms (bound "
              f"{t_bound:.4f}, {by}), backward {t_b:.4f} ms (bound {t_bbound:.4f}, {bby}), "
              f"Function fwd+bwd {t_fb:.4f} ms; plain fwd {t_pf:.4f}, fwd+bwd {t_pfb:.4f} ms; "
              f"eager einsum path fwd+bwd {t_yfb:.4f} ms")
        del args, d_out, d_raw
        torch.cuda.empty_cache()
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[K4-train] per train step ({sum(K4_TRAIN_SHAPES.values())} launches): K4 forward {res['ms']:.3f} ms (bound "
          f"{res['bound_ms']:.4f}), backward {res['backward_ms']:.3f} ms (bound "
          f"{res['backward_bound_ms']:.4f}), Function fwd+bwd {res['fwd_bwd_ms']:.3f} ms; plain "
          f"fwd+bwd {res['plain_fwd_bwd_ms']:.3f} ms, eager einsum fwd+bwd "
          f"{res['yardstick_fwd_bwd_ms']:.3f} ms")
    return res


def occlusions_from_disparity(disp):
    """(disp_right, occ_left, occ_right) of a left disparity map [H, W] > 0:
    every left pixel lands at x - d in the right view and the nearer (larger
    d) wins; a right pixel that nothing lands on is occluded and takes its
    row's disparity interpolated from the filled pixels; a left pixel is
    occluded where its match falls left of the frame or a nearer pixel
    covers it."""
    h, w = disp.shape
    xr = np.rint(np.arange(w)[None, :] - disp).astype(np.int64)
    inside = xr >= 0
    rows = np.broadcast_to(np.arange(h)[:, None], (h, w))
    right = np.full((h, w), -np.inf, np.float32)
    np.maximum.at(right, (rows[inside], xr[inside]), disp[inside])
    occ_right = ~np.isfinite(right)
    occ_left = ~inside
    occ_left[inside] = right[rows[inside], xr[inside]] > disp[inside] + 0.5
    for y in range(h):
        filled = np.flatnonzero(~occ_right[y])
        right[y] = np.interp(np.arange(w), filled, right[y, filled]) if filled.size else 0.0
    return right, occ_left, occ_right


THINGS_SUBS = ("left", "right", "disparity", "disparity_right", "occlusion", "occlusion_right")


def things_pair(root, hw, max_disp, i):
    """Random-dot stereogram `i` in the FlyingThings3D-subset layout (`write_things_set`)."""
    from openstereo_tpu_torch.data.readers import write_pfm
    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
    disp_right, occ, occ_right = occlusions_from_disparity(disp)
    paths = [f"{sub}/{i:04d}.{'pfm' if sub.startswith('disp') else 'png'}" for sub in THINGS_SUBS]
    for path, img in zip(paths[:2], (left, right)):
        save_png(np.clip(np.round(img), 0, 255).astype(np.uint8), root / path)
    write_pfm(str(root / paths[2]), disp)
    write_pfm(str(root / paths[3]), disp_right)
    for path, mask in zip(paths[4:], (occ, occ_right)):
        save_png(mask.astype(np.uint8) * 255, root / path)
    return " ".join(paths)


def write_things_set(root, n, first, hw, max_disp):
    """`n` random-dot stereograms in the FlyingThings3D-subset layout that
    `FlyingThings3DSubsetDataset` reads: left/, right/ PNG, disparity/ and
    disparity_right/ PFM, occlusion/ and occlusion_right/ PNG (255 where
    occluded); returns the split lines."""
    import functools

    for sub in THINGS_SUBS:
        (root / sub).mkdir(parents=True, exist_ok=True)
    return write_pairs(functools.partial(things_pair, root, hw, max_disp),
                       range(first, first + n))


def phase_sttr_train(dev, card, k4_train):
    """`run_sttr_training` on a FlyingThings3D-subset set written for it under
    `chiprun_out/`, which is deleted afterwards with the run's checkpoints."""
    import shutil

    shutil.rmtree(STTR_TRAIN_DIR, ignore_errors=True)
    data_root = STTR_TRAIN_DIR / "FlyingThings3D"
    try:
        return run_sttr_training(dev, card, data_root, k4_train)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
        for ckpt in STTR_TRAIN_DIR.glob("runs/**/ckpt"):
            shutil.rmtree(ckpt, ignore_errors=True)


@contextmanager
def pinned_windows():
    """STTR's window regression (`models/sttr/sttr.py:low_res_disp`) given, at
    every call after the first inside the block, the first call's argmax. An
    argmax is a step function: where a pixel's two best matches tie to within
    f32's rounding, two evaluations of one step may regress windows a pixel
    apart (the f32 steps on the card do, kernels and eager alike, from one run
    to the next: the cuDNN backward sums in no fixed order), and the gradient
    then jumps by far more than the rounding. Pinned to the f64 step's windows,
    the f32 steps differ from it by rounding alone. Yields {"windows": the
    number of windows, "moved": how many of them each later call's own argmax
    would have moved}."""
    sttr_mod = importlib.import_module("openstereo_tpu_torch.models.sttr.sttr")
    real = sttr_mod.low_res_disp
    first, pins = [], {"windows": 0, "moved": []}

    def low_res_disp(attn, occ_mask=None):
        own = attn.argmax(dim=-1, keepdim=True)
        if first:
            pins["moved"].append(int((own != first[0]).sum()))
        else:
            first.append(own)
            pins["windows"] = own.numel()
        return real(attn, occ_mask, best=first[0])

    sttr_mod.low_res_disp = low_res_disp
    try:
        yield pins
    finally:
        sttr_mod.low_res_disp = real


def sttr_step_grads(model, batch, use_kernels):
    """One forward, loss and backward of `model` in training on `batch` through
    the kernel or the eager path: (loss terms, gradients by name, K4 launches)."""
    import torch

    from openstereo_tpu_torch.models import set_kernels
    from openstereo_tpu_torch.ops import kernels

    set_kernels(model, use_kernels)
    model.train()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    loss, info = model.get_loss(model(batch), batch)
    loss.backward()
    torch.cuda.synchronize()
    launches = kernels.launch_counts["rel_attention"]
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    set_kernels(model, True)
    return {k: float(v.detach()) for k, v in info.items()}, grads, launches


def compare_step_grads(runs_k, runs_e, grads_64):
    """f32 steps of the kernel and the eager path (lists of gradients by name,
    one per run) against the same step in f64, tensor by tensor: the worst
    (name, max-abs / max|g| of the tensor) of kernels vs eager (run i against
    run i), kernels vs f64 (the kernel runs' median) and eager vs f64 (the
    eager runs' worst; tensors above 1e-4 of the largest gradient), and the
    worst (name, ratio) of the kernel runs' median error against 2x the eager
    runs' worst plus 1e-4·max|g| of the tensor plus 1e-6·max|g| of the model
    (the floor for gradients that vanish in exact arithmetic: a bias that an
    InstanceNorm cancels gets rounding noise). f32 itself sets the eager
    path's error (far above 1e-4·max|g| in the full-resolution convs); the
    kernel path must be no worse. One run's error is no measure of f32's: from
    one run to the next of either path (the cuDNN backward sums in no fixed
    order) a tensor's error jumps between levels 2-4x apart (STTR on the H100:
    `backbone.branch1.1.weight` 1.0e-4 or 4.4e-4), so one eager run held
    against another by this rule fails in 22-40 % of the pairs. A fault of
    the kernel path moves every run, so the median of its runs against the
    worst of the eager runs keeps the rule's teeth (the shifted-`_unskew`
    control fails it ~5000x) without the coin toss (drawn from 12 + 12 runs,
    6 a side fail it in at most 0.3 % of the draws, eager against eager 0.7
    %; `STTR_GRAD_RUNS` takes 12)."""
    names = list(grads_64)
    scale = np.array([grads_64[k].abs().max().item() for k in names])
    gmax = scale.max()

    def errs(runs):  # [run, tensor] max-abs against the f64 step
        return np.array([[(g[k].double() - grads_64[k]).abs().max().item() for k in names]
                         for g in runs])

    err_k, err_e = np.median(errs(runs_k), axis=0), errs(runs_e).max(axis=0)
    k_vs_e = np.max([[(gk[k] - ge[k]).abs().max().item() for k in names]
                     for gk, ge in zip(runs_k, runs_e)], axis=0)
    big = scale > 1e-4 * gmax

    def worst(d):
        r = np.full(len(names), -1.0)
        r[big] = d[big] / scale[big]
        return names[int(r.argmax())], float(r.max())

    ratio = err_k / (2 * err_e + 1e-4 * scale + 1e-6 * gmax)
    return {"k_vs_e": worst(k_vs_e), "k_vs_64": worst(err_k), "e_vs_64": worst(err_e),
            "ratio": (names[int(ratio.argmax())], float(ratio.max()))}


def timed_train_steps(trainer, batch, steps=4):
    """`Trainer.train_step` on `batch` `steps` times, its parts (forward and
    loss, backward, optimizer) between CUDA events: per step (total, forward,
    backward, optimizer) ms, and the peak memory over the steps."""
    import torch

    dev = trainer.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        trainer._set_train_mode()
        ev[0].record()
        loss, _ = trainer.model.get_loss(trainer.model(batch), batch)
        ev[1].record()
        trainer.state.optimizer.zero_grad()
        loss.backward()
        ev[2].record()
        trainer.state.optimizer.step()
        trainer.state.step += 1
        ev[3].record()
        events.append(ev)
    torch.cuda.synchronize()
    times = [(ev[0].elapsed_time(ev[3]), ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
              ev[2].elapsed_time(ev[3])) for ev in events]
    return times, torch.cuda.max_memory_allocated(dev)


def run_sttr_training(dev, card, data_root, k4_train):
    """The port's training entry point (`tools/train.py`) on
    `cfgs/sttr/sttr_flyingthings3d.yaml` as it is (RandomCrop 360x640, b1, f32,
    RMSprop 1e-3, MultiStepLR on epochs with 100 warm-up steps, clip by norm
    35; evaluation at 540x960) but for the data paths and NUM_EPOCHS 1 (8
    steps on a synthetic set). K4 must launch 18 times a train step at the
    three training shapes and 18 times an evaluation frame at W 320, and no
    other kernel; then one step of the same weights and batch through both
    paths, the evaluation eager, a resumed Trainer, and both paths' step
    times, peak memory and profiles."""
    import torch
    import yaml

    from openstereo_tpu_torch.config import Config
    from openstereo_tpu_torch.data.loader import batch_to_device
    from openstereo_tpu_torch.models import set_kernels
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.runtime import Trainer
    from openstereo_tpu_torch.tools import train

    t0 = time.perf_counter()
    split = {}
    for mode, n, first in (("train", STTR_TRAIN_PAIRS, 0),
                           ("test", STTR_EVAL_PAIRS, STTR_TRAIN_PAIRS)):
        split[mode] = STTR_TRAIN_DIR / f"things_{mode}.txt"
        split[mode].write_text("\n".join(write_things_set(data_root, n, first, PAIR_HW,
                                                           STTR_PAIR_MAX_DISP)))
    print(f"[sttr-train] wrote {STTR_TRAIN_PAIRS} + {STTR_EVAL_PAIRS} random-dot pairs at "
          f"{PAIR_HW[0]}x{PAIR_HW[1]} (PNG views and occlusions, PFM disparities left and right) "
          f"in {time.perf_counter() - t0:.1f} s")

    cfg = yaml.safe_load(STTR_CFG.read_text())
    info = cfg["DATA_CONFIG"]["DATA_INFOS"][0]
    info["DATA_SPLIT"] = {"TRAINING": str(split["train"]), "EVALUATING": str(split["test"]),
                          "TESTING": str(split["test"])}
    info["DATA_PATH"] = str(data_root)
    cfg["OPTIMIZATION"]["NUM_EPOCHS"] = 1  # the cut: 8 pairs at batch 1 = 8 steps
    cfg_file = STTR_TRAIN_DIR / "sttr_flyingthings3d.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    paths = STTR_TRAIN_DIR / "data_paths.yaml"
    paths.write_text(yaml.safe_dump({info["DATASET"]: str(data_root)}))
    opt = cfg["OPTIMIZATION"]
    print(f"[sttr-train] config: crop {cfg['DATA_CONFIG']['DATA_TRANSFORM']['TRAINING'][0]['SIZE']}, "
          f"batch {opt['BATCH_SIZE_PER_GPU']}, AMP {opt['AMP']}, {opt['OPTIMIZER']['NAME']} "
          f"{opt['OPTIMIZER']['LR']}, {opt['SCHEDULER']['NAME']} warm-up "
          f"{opt['SCHEDULER']['WARMUP']}, clip {opt['CLIP_GRAD']}, NUM_EPOCHS {opt['NUM_EPOCHS']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train.main(["--cfg_file", str(cfg_file), "--save_root", str(STTR_TRAIN_DIR / "runs"),
                          "--data_paths", str(paths), "--workers", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    shapes = dict(kernels.launch_shapes["rel_attention"])
    peak_run = torch.cuda.max_memory_allocated(dev)
    steps, n_eval = trainer.state.step, trainer.eval_loader.steps_per_epoch
    check(steps == STTR_TRAIN_PAIRS and n_eval == STTR_EVAL_PAIRS,
          f"{steps} train steps, {n_eval} evaluation frames")
    losses, step_ms = trainer.epoch_losses, trainer.epoch_step_ms
    check(len(losses) == steps and all(np.isfinite(v) for v in losses), f"losses {losses}")
    per_step, per_frame = sum(K4_TRAIN_SHAPES.values()), sum(K4_SHAPES.values())
    want = {**{k: n * steps for k, n in K4_TRAIN_SHAPES.items()},
            **{k: n * n_eval for k, n in K4_SHAPES.items()}}
    print(f"[sttr-train] launches over the run ({steps} train steps, {n_eval} evaluation "
          f"frames): {launches}; K4 by shape {shapes}")
    check(launches == {"corr_volume": 0, "fused_mbconv": 0, "gwc_volume": 0,
                       "rel_attention": per_step * steps + per_frame * n_eval},
          f"launches {launches} != K4 {per_step} per train step and {per_frame} per evaluation "
          "frame, nothing else")
    check(shapes == want, f"K4 launch shapes {shapes} != {want}")
    records = [json.loads(ln) for ln in open(trainer.metrics_file)]
    wired = [r for r in records if r["phase"] == "eval"][-1]
    check(all(np.isfinite(v) for k, v in wired.items() if k != "phase"), f"{wired}")

    batches = trainer.train_loader.epoch(1)
    batch = batch_to_device(next(batches), dev)
    batches.close()
    model = trainer.model
    batch64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
               for k, v in batch.items()}
    # the same step in f64 first (eager: the kernel takes f32 and bf16): the exact gradient
    # that the f32 steps are held against, and the regression windows they all take
    with pinned_windows() as pins:
        m64 = copy.deepcopy(model).double()
        m64.dtype = torch.float64
        _, grads_64, _ = sttr_step_grads(m64, batch64, False)
        del m64
        runs = {"kernels": [], "eager": []}
        for _ in range(STTR_GRAD_RUNS):
            for path, rs in runs.items():
                rs.append(sttr_step_grads(model, batch, path == "kernels"))
        with shifted_unskew():
            _, grads_c, _ = sttr_step_grads(model, batch, True)
    (infos_k, runs_k, n_k), (infos_e, runs_e, n_e) = (zip(*runs[p]) for p in ("kernels", "eager"))
    check(set(n_k) == {per_step} and set(n_e) == {0},
          f"one step launched K4 {n_k} times (kernels), {n_e} (eager)")
    check(all(g.keys() == grads_64.keys() for g in (*runs_k, *runs_e, grads_c)),
          "the paths give gradients to other parameters")
    info_k = infos_k[0]
    loss_err = {k: max(abs(ik[k] - ie[k]) / max(abs(ie[k]), 1e-30)
                       for ik, ie in zip(infos_k, infos_e)) for k in info_k}
    grad_cmp = compare_step_grads(runs_k, runs_e, grads_64)
    control = compare_step_grads([grads_c], runs_e, grads_64)["ratio"]
    moved = pins["moved"]
    grad_cmp.update(control=control, runs=STTR_GRAD_RUNS, windows=pins["windows"],
                    windows_moved=max(moved))
    print(f"[sttr-train] one step, {STTR_GRAD_RUNS} runs of each path (f32, TF32 off): loss "
          f"terms kernels { {k: round(v, 6) for k, v in info_k.items()} }, relative differences "
          f"{ {k: float(f'{v:.3g}') for k, v in loss_err.items()} } (tol 1e-5); gradients of "
          f"{len(grads_64)} tensors: kernels vs eager worst {grad_cmp['k_vs_e'][1]:.3g}·max|g| at "
          f"{grad_cmp['k_vs_e'][0]}; against the f64 step, kernels (median) worst "
          f"{grad_cmp['k_vs_64'][1]:.3g}·max|g| at {grad_cmp['k_vs_64'][0]}, eager worst "
          f"{grad_cmp['e_vs_64'][1]:.3g}·max|g| at {grad_cmp['e_vs_64'][0]} (of the tensors above "
          f"1e-4 of the largest gradient); the kernel runs' median error over 2x the eager "
          f"runs' worst + 1e-4·max|g| + "
          f"1e-6·max|g| of the model: worst {grad_cmp['ratio'][1]:.3g} at {grad_cmp['ratio'][0]} "
          f"(tol 1); the control (K4's backward with `_unskew` shifted) worst {control[1]:.3g} "
          f"at {control[0]} (must exceed 1); the f32 steps regress the f64 step's windows, where "
          f"their own argmax would have moved at most {max(moved)} of {pins['windows']}")
    check(all(v <= 1e-5 for v in loss_err.values()), f"loss terms differ: {loss_err}")
    check(grad_cmp["ratio"][1] <= 1.0,
          f"gradient of {grad_cmp['ratio'][0]}: the kernel runs' median error against the f64 "
          f"step is {grad_cmp['ratio'][1]} of 2x the eager runs' worst + 1e-4·max|g| + "
          f"1e-6·max|g| (model)")
    check(control[1] > 1.0, f"the control with K4's `_unskew` shifted by one column passes the "
                            f"gradient check (worst {control[1]} at {control[0]})")
    del runs, runs_k, runs_e, grads_c, grads_64

    set_kernels(model, False)
    kernels.reset_launch_counts()
    eager = trainer.evaluate(0)
    check(sum(kernels.launch_counts.values()) == 0, "the eager evaluation launched kernels")
    set_kernels(model, True)
    d_epe = abs(wired["epe"] - eager["epe"])
    print(f"[sttr-train] evaluation at 540x960 f32 with kernels: "
          f"{ {k: round(v, 4) for k, v in wired.items() if k not in ('phase', 'epoch')} }; eager: "
          f"{ {k: round(v, 4) for k, v in eager.items()} }; |EPE difference| {d_epe:.4g} px "
          f"(tol 0.5)")
    check(d_epe <= 0.5, f"evaluation with kernels vs eager: EPE differs by {d_epe} px > 0.5")

    check(trainer.saved_epochs() == [0], f"checkpoints {trainer.saved_epochs()}")
    saved = torch.load(trainer.ckpt_path(0), map_location="cpu", weights_only=True)
    again = Trainer(Config.from_dict(cfg), trainer.run_dir, device=dev, num_workers=8)
    start = again.resume_ckpt()
    state = again.model.state_dict()
    same = all(torch.equal(state[k].cpu(), v) for k, v in saved["model_state"].items())
    nu = again.state.optimizer.state_dict()["state"]
    same_nu = all(torch.equal(nu[k]["nu"].cpu(), st["nu"])
                  for k, st in saved["optimizer_state"]["state"].items())
    check(start == 1 and again.state.step == steps and same and same_nu
          and again.state.optimizer.name == "rmsprop",
          f"resume: start epoch {start}, step {again.state.step}, parameters bit-equal {same}, "
          f"RMSprop nu bit-equal {same_nu}")
    print(f"[sttr-train] resumed Trainer: start epoch {start}, step {again.state.step}, "
          f"{len(saved['model_state'])} tensors and {len(nu)} RMSprop nu tensors bit-equal to "
          f"the checkpoint")
    del trainer, model
    torch.cuda.empty_cache()

    paths_res = {}
    for path in ("kernels", "eager"):
        set_kernels(again.model, path == "kernels")
        times, peak = timed_train_steps(again, batch)
        ms = float(np.median([t[0] for t in times[1:]]))
        fwd, bwd, optim = (float(np.median([t[i] for t in times[1:]])) for i in (1, 2, 3))
        prof = profile_train_steps(again, ms, batch,
                                   label=f"STTR b1 360x640 f32, {path}",
                                   table=STTR_TRAIN_DIR / f"profile_train_step_{path}.txt")
        paths_res[path] = {"ms_per_step": ms, "samples_per_s": 1e3 / ms, "step_ms": times,
                           "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": optim,
                           "backward_share": bwd / ms, "peak_bytes": peak, "profile": prof}
        print(f"[sttr-train] {path}: {ms:.2f} ms/step (median of steps 2-{len(times)}, CUDA "
              f"events), {1e3 / ms:.3f} samples/s; forward+loss {fwd:.2f} ms, backward {bwd:.2f} "
              f"ms ({bwd / ms:.1%} of the step), optimizer {optim:.2f} ms; peak memory "
              f"{peak / 2**30:.3f} GiB; device busy "
              f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle share "
              f"{prof['idle_share']:.4f}")
    set_kernels(again.model, True)
    ms_k = paths_res["kernels"]["ms_per_step"]
    shares = {"k4_forward": k4_train["ms"] / ms_k, "k4_backward": k4_train["backward_ms"] / ms_k}
    print(f"[sttr-train] run: {steps} steps, step ms (CUDA events) {[round(t, 2) for t in step_ms]}; "
          f"losses {[round(v, 4) for v in losses]}; peak memory over the run "
          f"{peak_run / 2**30:.3f} GiB; wall {wall:.1f} s; K4's share of the kernel path's step "
          f"(phase 23's times): forward {shares['k4_forward']:.1%}, backward "
          f"{shares['k4_backward']:.1%}")
    del again
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "peak_bytes_run": peak_run,
            "train_launches": per_step * steps, "eval_launches": per_frame * n_eval,
            "eval_frames": n_eval,
            "eval_kernels": wired, "eval_eager": eager, "loss_err": loss_err,
            "grads": grad_cmp, "paths": paths_res, "k4_shares": shares}


def phase_sttr_overfit():
    """The learning check of STTR: the port's `tools/overfit_check.py`, 40
    steps on one batch of 2 random-dot pairs at 192x384, f32, RMSprop 1e-4
    constant, clip by norm 35; the mean loss of the last 20 steps must fall
    below 0.8 of the first 5 steps'."""
    from openstereo_tpu_torch.tools import overfit_check

    t0 = time.perf_counter()
    res = overfit_check.main(STTR_OVERFIT_ARGS)
    took = time.perf_counter() - t0
    traj = [(s, round(l, 4), round(e, 3)) for s, l, e in res["trajectory"]]
    rr = res["components"]["loss_rr"]
    rr_ratio = float(np.mean(rr[-20:]) / np.mean(rr[:5]))
    print(f"[sttr-overfit] trajectory (step, loss, train EPE px): {traj}; loss ratio (last 20 / "
          f"first 5) {res['loss_ratio']:.4f} (tol < 0.8); rr term ratio {rr_ratio:.4f}; "
          f"{took:.1f} s")
    check(res["loss_ratio"] < 0.8, f"STTR overfit check: loss ratio {res['loss_ratio']} >= 0.8")
    res["rr_ratio"] = rr_ratio
    return res


def k4_train_entry(k4_train, sttr_trained):
    """The JSON entry of K4 under autograd (`rel_attention_trainable`): the
    launches of phase 24's train steps, phase 23's times per train step (K4's
    forward as `ms`, the PyTorch backward beside it) and errors."""
    return dict(name="rel_attention_trainable", route="cuda",
                source="openstereo_tpu_torch/csrc/rel_attention.cu",
                replaces="openstereo_tpu/ops/pallas/rel_attention.py:243",
                launches=sttr_trained["train_launches"],
                launches_per_step=sum(K4_TRAIN_SHAPES.values()),
                launches_trainer_eval=sttr_trained["eval_launches"],
                max_abs_err=k4_train["max_abs_err"], max_grad_err=k4_train["max_grad_err"],
                library_ms=None, dtype="float32",
                backward="PyTorch, openstereo_tpu_torch/ops/rel_attention.py:rel_attention_backward",
                yardstick="the port's eager einsum path under autograd (forward + backward)",
                controls=k4_train["control"],
                **{k: v for k, v in k4_train.items()
                   if k not in ("max_abs_err", "max_grad_err", "control")})


def sttr_train_summary(sttr_trained, sttr_overfit, t0):
    pk, pe = sttr_trained["paths"]["kernels"], sttr_trained["paths"]["eager"]
    return (f"[sttr-train] STTR 360x640 b1 f32 RMSprop: kernels {pk['ms_per_step']:.2f} ms/step "
            f"({pk['samples_per_s']:.3f} samples/s, peak {pk['peak_bytes'] / 2**30:.3f} GiB, idle "
            f"{pk['profile']['idle_share']:.4f}, backward {pk['backward_share']:.1%}), eager "
            f"{pe['ms_per_step']:.2f} ms/step ({pe['samples_per_s']:.3f} samples/s, peak "
            f"{pe['peak_bytes'] / 2**30:.3f} GiB, idle {pe['profile']['idle_share']:.4f}, "
            f"backward {pe['backward_share']:.1%}); evaluation EPE "
            f"{sttr_trained['eval_kernels']['epe']:.4f} px with kernels, "
            f"{sttr_trained['eval_eager']['epe']:.4f} eager; overfit loss ratio "
            f"{sttr_overfit['loss_ratio']:.4f}; total {time.perf_counter() - t0:.1f} s")


def batch2(shapes, batch=ZOO_EVAL_BATCH):
    """Launch shapes per b1 frame → per evaluation batch of `batch` (each key
    leads with its batch)."""
    return {(s[0] * batch,) + tuple(s[1:]): n for s, n in shapes.items()}


@contextmanager
def detached_volume(model, targets):
    """Within it, the volume builders `targets` ((module under
    `openstereo_tpu_torch.models`, name), or (None, a method of `model`)) get
    their two feature inputs detached: the control of `zoo_grad_check`."""
    patches = []
    for mod, attr in targets:
        owner = model if mod is None else importlib.import_module(
            f"openstereo_tpu_torch.models.{mod}")
        patches.append((owner, attr, getattr(owner, attr), mod is None))
    for owner, attr, fn, _ in patches:
        setattr(owner, attr,
                lambda l, r, *a, _fn=fn, **kw: _fn(l.detach(), r.detach(), *a, **kw))
    try:
        yield
    finally:
        for owner, attr, fn, method in patches:
            if method:
                delattr(owner, attr)  # the instance attribute: the method shows again
            else:
                setattr(owner, attr, fn)


@contextmanager
def undetached(model, targets):
    """Within it, the functions `targets` ((module under
    `openstereo_tpu_torch.models`, name): the IGEV family's `carried`, the GRU
    loop's detach of the carried disparity) are the identity: the control of
    `zoo_grad_check` for the IGEV family."""
    patches = [(importlib.import_module(f"openstereo_tpu_torch.models.{mod}"), attr)
               for mod, attr in targets]
    saved = [getattr(owner, attr) for owner, attr in patches]
    for owner, attr in patches:
        setattr(owner, attr, lambda x: x)
    try:
        yield
    finally:
        for (owner, attr), fn in zip(patches, saved):
            setattr(owner, attr, fn)


class ZooPath(NamedTuple):
    """A training path of phases 26-34 (`zoo_train_paths`)."""
    name: str
    cfg: Path
    want: Dict  # the trainer evaluation's launches per batch, by kernel and shape
    topk_input: Optional[str]  # the module feeding a top-k head (CoEx's bf16 rule) or None
    targets: List  # the volume builders the detach control patches (`detached_volume`)
    remat: bool  # whether to measure MODEL.REMAT's peak
    rel: float  # the gradient check's bound relative to each tensor's largest magnitude
    eval_batch: Optional[int] = ZOO_EVAL_BATCH  # None: the config's own
    eval_pairs: int = ZOO_EVAL_PAIRS
    tf32_off_timing: bool = True  # also time 4 steps with TF32 off (an f32 config)
    rule: str = "max_abs"  # the evaluation against eager (`zoo_eval_agreement`)
    grad_hw: tuple = ZOO_GRAD_HW  # the gradient check's crop
    # the gradient check's control, a context manager over (model, targets) that must make
    # the check fail: `detached_volume` or, for the IGEV family, `undetached`
    control: Callable = detached_volume


def zoo_train_paths():
    """Phases 26-34, as `ZooPath`s.

    The bounds of phases 26-30 are twice the first runs' worst f32 error among
    the tensors above 1e-4 of the model's largest gradient (GwcNet 0.054,
    PSMNet 0.031, CoEx 0.14, MSNet3D 0.475, MSNet2D 0.164; two runs within
    0.5 % of each other), plus ZOO_GRAD_FLOOR of the model's largest. They are
    f32's own error, not the port's: a conv weight that a training BatchNorm
    follows is scale-invariant, so its exact gradient is a difference of
    near-equal sums, largest in the mobile trunks' stems (MSNet3D's first 1x1
    conv, its largest gradient, lies 0.475 of itself from f64 on the card and
    0.16 on the CPU), and the f32 3D convs run cuDNN's FFT algorithms. JAX's
    own f32 step lies as far from its f64 step (PERF.md). The check's teeth
    are the tensor set and the magnitudes: the detach control leaves 5-333
    tensors without a gradient.

    Phases 31-34 evaluate at their configs' own batch (CFNet 1, the others 10)
    and skip the TF32-off timing, MODEL.REMAT and the resume check (the
    script's time). Their bounds (`ZOO_NEW_BOUNDS`) hold twice the worst f32
    error of 3 runs on the card at every tensor, the floor included: the rel
    that takes needs CFNet 0 (the floor alone covers twice every error; the
    worst error is 0.019 of its tensor's largest magnitude, in a tensor below
    the floor), CasGwcNet 0.246 (its FPN head `out2`, 0.19 of itself: the
    scale-invariant convs before training BatchNorms, as in phases 26-30),
    CasPSMNet 0.066 and FADNet 0.0128 (an error of 0.094 of the tensor in
    `disp_predictor.conv5.conv1`, whose gradient is 0.006 of the model's
    largest). The rule holds each tensor to the floor where that covers it,
    not to its own largest magnitude as phases 26-30's do: FADNet's detach
    control removes no tensor's gradient (the backbone also feeds
    `conv_redir` and the decoders) and changes the backbone's by 0.056 of
    each tensor's largest magnitude beyond the floor, which a bound of twice
    the worst error relative to the tensor (0.19) would let pass. The other
    controls leave 20 (CFNet), 173 and 186 (the cascades) tensors without a
    gradient."""
    cf_eval, fad_eval = 1, 10
    return [
        ZooPath("GwcNet", GWC_CFG, {"gwc_volume": batch2({K3_SHAPE: 1})}, None,
                [("gwcnet.gwcnet", "build_gwc_volume"), ("gwcnet.gwcnet", "build_concat_volume")],
                True, 0.11),
        ZooPath("PSMNet", PSM_CFG, {}, None, [("psmnet.psmnet", "build_concat_volume")], True,
                0.063),
        ZooPath("CoEx", COEX_CFG, {"corr_volume": batch2({COEX_K1_SHAPE: 1}),
                                   "fused_mbconv": batch2(COEX_K2_SHAPES)},
                "CostProcessor.cost_agg", [("coex.coex", "correlation_volume")], False, 0.28),
        ZooPath("MSNet3D", MSNET3D_CFG, {"gwc_volume": batch2({K3_SHAPE: 1}),
                                         "fused_mbconv": batch2(MSNET3D_K2_SHAPES)},
                None, [("msnet.msnet", "build_gwc_volume")], False, 0.95),
        ZooPath("MSNet2D", MSNET2D_CFG, {"fused_mbconv": batch2(MSNET2D_K2_SHAPES)}, None,
                [(None, "interlaced_volume")], False, 0.33),
        ZooPath("CFNet", CFNET_CFG, {"gwc_volume": batch2(CFNET_K3_SHAPES, cf_eval)}, None,
                [("cfnet.cfnet", "build_gwc_volume"), ("cfnet.cfnet", "warped_volumes")], False,
                ZOO_NEW_BOUNDS["CFNet"], None, 2 * cf_eval, False, "share"),
        ZooPath("CasGwcNet", CASGWC_CFG, {}, None,
                [("casnet.casnet", "build_warped_gwc_volume"),
                 ("casnet.casnet", "build_warped_concat_volume")], False,
                ZOO_NEW_BOUNDS["CasGwcNet"], None, ZOO_CFG_EVAL_PAIRS, False, "finite"),
        ZooPath("CasPSMNet", CASPSM_CFG, {}, None,
                [("casnet.casnet", "build_warped_concat_volume")], False,
                ZOO_NEW_BOUNDS["CasPSMNet"], None, ZOO_CFG_EVAL_PAIRS, False, "finite"),
        ZooPath("FADNet", FADNET_CFG, {"corr_volume": batch2({FADNET_K1_SHAPE: 1}, fad_eval)},
                None, [("fadnet.fadnet", "correlation_volume")], False, ZOO_NEW_BOUNDS["FADNet"],
                None, ZOO_CFG_EVAL_PAIRS, False),
        *igev_family_train_paths(),
        *fs_family_train_paths(),
    ]


def igev_family_train_paths():
    """Phases 41-44: IGEV, IGEV-RT, StereoBase and IGEV++, as `ZooPath`s. Each
    SceneFlow config as written (crop, batch, bf16, AdamW, its schedule and
    clip, FREEZE_BN, IGEV's MODEL.REMAT, 22 GRU iterations), evaluated in one
    batch at its config's EVALUATOR batch (IGEV 10, IGEV-RT 8, StereoBase and
    IGEV++ 4) at 544x960: K3 once a batch at [b,96,136,240] D 48 G 8 (IGEV++
    D 192) and K2 11 times at CoEx's trunk shapes at batch 2b (both views);
    the evaluation against eager by the rule "share_f32" (`zoo_eval_agreement`);
    no TF32-off timing, no MODEL.REMAT peak, no resume check (the script's
    time). The gradient check's control is the GRU loop without its detach
    (`carried` made the identity), so that the gradient flows through the
    carried disparity; the bounds (`IGEV_FAMILY_BOUNDS`) hold twice the worst
    f32 error of 3 runs on the card at every tensor, the floor included,
    rounded up to the next 0.01 (the "rel needed" that `zoo_grad_check`
    prints, over 3 f32 steps against the f64 step per model): IGEV needs 0.385 (its
    trunk's first blocks, `feature.block1.0.0.bn1.bias` and
    `feature.block0.0.0.conv_pw.weight`, 0.18 of themselves from f64 in each
    run: the scale-invariant convs before training BatchNorms, as in phases
    26-34), StereoBase 0.0475 (`feature.conv_stem.weight`), IGEV++ 0.0022 and
    IGEV-RT 0 (the floor covers twice every error). Two runs under PyTorch's
    default algorithms differ by up to 2.6e-4·max|g| of the model (the
    gathers' backward adds with atomics); under `use_deterministic_algorithms`
    two runs are bit-equal. At the unrounded rel the control leaves 351, 204,
    319 and 273 tensors beyond the bound (the update block, the context net,
    the hourglass, the trunk), 17.5-30 of a tensor's largest magnitude at its
    worst."""
    paths = []
    for name, cfg, planes in (("IGEV", IGEV_CFG, 48), ("IGEV-RT", IGEV_RT_CFG, 48),
                              ("StereoBase", STEREOBASE_CFG, 48), ("IGEV++", IGEVPP_CFG, 192)):
        b = IGEV_FAMILY_EVAL_BATCH[name]
        want = {"gwc_volume": {(b, 96, 136, 240, planes, 8): 1},
                "fused_mbconv": batch2(COEX_K2_SHAPES, b)}
        paths.append(ZooPath(name, cfg, want, None, [("igev.igev", "carried")], False,
                             IGEV_FAMILY_BOUNDS[name], None, b, False, "share_f32",
                             (128, 768) if name == "IGEV++" else ZOO_GRAD_HW, undetached))
    return paths


def fs_family_train_paths():
    """Phases 49-51: FoundationStereo, FastFoundationStereo and MonSter, as
    `ZooPath`s. Each SceneFlow config as written (crop 320x736, batch 2, 2
    and 3, bf16, AdamW, OneCycleLR, clip by norm 1; FoundationStereo vits
    with its frozen ViT and 22 GRU iterations, FastFoundationStereo 12 of one
    scale, MonSter 15 + 7 mutual with FREEZE_BN), evaluated in one batch at
    its config's EVALUATOR batch (1, 1, 8) at 544x960: K3 once a batch
    (`FS_VITS_K3_SHAPE`, `FFS_K3_SHAPE`, `MONSTER_EVAL_K3_SHAPE`), nothing
    else; kernels vs eager by "share_f32", the f32 passes at b1 through cuDNN
    (deterministic) and MonSter's at b8 through PyTorch's own convolutions;
    no TF32-off timing, MODEL.REMAT or resume check (the script's time). The
    gradient check's control is the GRU loops without their detach: each
    model's module binds its own `carried` by import, so the control makes
    the identity of `foundationstereo.foundationstereo.carried` (both
    FoundationStereo models) or `monster.monster.carried` (MonSter's IGEV
    and mutual iterations). The bounds (`FS_FAMILY_BOUNDS`) are twice the
    worst f32 error of 3 runs on the card relative to its tensor's largest
    magnitude, over the tensors above 1e-4 of the model's largest gradient,
    rounded up to the next 0.01, against an f64 step that runs every
    submodule in f64: FoundationStereo 2 x 0.164 (`cost_agg.agg_0.2`, the
    hourglass's scale-invariant convs before training BatchNorms; 0.159 and
    0.156 in the other runs), FastFoundationStereo 2 x 0.266
    (`cost_agg.conv3_up`; 0.265 and 0.258), MonSter 2 x 0.0223
    (`cost_agg.agg_0.1`; 0.0079 and 0.0213; the floor alone covers every
    error). That is at least the rel at which each of those tensors' bound,
    floor included, holds twice its error ("for twice each error": 0.241,
    0.509, 0). The control leaves 40.5, 11 and 28.5 of a tensor's largest
    magnitude beyond the floor (the update blocks, the context heads)."""
    out = []
    for name, cfg, shape, module in (
            ("FoundationStereo", FS_SF_CFG, FS_VITS_K3_SHAPE, "foundationstereo"),
            ("FastFoundationStereo", FFS_CFG, FFS_K3_SHAPE, "foundationstereo"),
            ("MonSter", MONSTER_CFG, MONSTER_EVAL_K3_SHAPE, "monster")):
        b = FS_FAMILY_EVAL_BATCH[name]
        out.append(ZooPath(name, cfg, {"gwc_volume": {shape: 1}}, None,
                           [(f"{module}.{module}", "carried")], False, FS_FAMILY_BOUNDS[name],
                           None, b, False, "share_f32", ZOO_GRAD_HW, undetached))
    return out


def check_volume_kernel(dev, kernel, shape, g, tag):
    """K1 (`kernel` "corr_volume", shape (B, C, H, W, D)) or K3 ("gwc_volume",
    (B, C, H, W, D, G)) against its plain version on random inputs: f32 (TF32
    off) `volume_f32_check`, bf16 `volume_bf16_check`. Returns (f32 max-abs,
    bf16 max-abs, bf16 share not bit-equal)."""
    import torch

    from openstereo_tpu_torch import ops

    b, c, h, w, *rest = shape
    fn, plain = ((ops.corr_volume, ops.correlation_volume) if kernel == "corr_volume"
                 else (ops.gwc_volume, ops.build_gwc_volume))
    left, right = (torch.randn(b, c, h, w, generator=g).to(dev) for _ in range(2))
    cg = c // (rest[1] if kernel == "gwc_volume" else 1)
    err32, bits32 = volume_f32_check(fn(left, right, *rest), plain(left, right, *rest), cg,
                                     f"{tag} f32 {shape}")
    lb, rb = left.bfloat16(), right.bfloat16()
    err16, share = volume_bf16_check(fn(lb, rb, *rest), plain(lb, rb, *rest),
                                     f"{tag} bf16 {shape}")
    print(f"{tag} {shape}: f32 max-abs {err32:.3g} (tol 1e-5), {bits32:.3g} not bit-equal (cap 0 "
          f"where C/G < {F32_EXACT_CG}), bf16 max-abs {err16:.3g} (tol 8e-3·|ref| + 1e-3), "
          f"{share:.3g} not bit-equal (cap {VOLUME_FLIP_SHARE})")
    return err32, err16, share


def check_k2_shapes(dev, shapes, g, tag):
    """K2 against its plain version at each shape (with and without the residual
    where Cin == Cout): f32 (TF32 off) within rtol 1e-4, atol 1e-4; bf16
    `bf16_close_flips`. Returns (worst f32 max-abs, worst bf16 max-abs, the
    launcher's split count by shape)."""
    import torch

    from openstereo_tpu_torch import ops
    from openstereo_tpu_torch.ops.kernels import build

    lib = build.load("fused_mbconv")
    worst32 = worst16 = 0.0
    splits_by_shape = {}
    for shape in shapes:
        b, h, w, cin, ch, cout = shape[:6]
        splits = lib.fused_mbconv_splits(b, h, w, ch, 1)
        chunks = -(-ch // 32)
        check(splits >= 1 and (splits - 1) * -(-chunks // splits) < chunks,
              f"K2 {shape[:6]}: the launcher picks {splits} splits of {chunks} chunks")
        splits_by_shape[shape[:6]] = splits
        x, args = k2_inputs(shape, dev, torch.float32, g)
        x16, args16 = x.bfloat16(), [a.bfloat16() if i % 2 == 0 else a for i, a in enumerate(args)]
        allowance = k2_flip_allowance(x16, args16)
        for res in ((True, False) if cin == cout else (False,)):
            ref = ops.mbconv_plain(x, *args, residual=res)
            got = ops.fused_mbconv(x, *args, residual=res)
            e32 = (got - ref).abs().max().item()
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"K2 f32 {shape[:6]} residual={res}: max-abs {e32} beyond rtol 1e-4, atol 1e-4")
            del ref, got
            e16, beyond = k2_bf16_error(ops.fused_mbconv(x16, *args16, residual=res),
                                        ops.mbconv_plain(x16, *args16, residual=res), allowance,
                                        f"{shape[:6]} residual={res}")
            print(f"{tag} K2 {shape[:6]} residual={res}, S={splits}: f32 max-abs {e32:.3g} (tol "
                  f"1e-4 + 1e-4·|ref|), bf16 max-abs {e16:.3g} (tol 8e-3·|ref| + 1e-3; {beyond} of "
                  f"{x16.numel() // cin * cout} beyond it, within the flip allowance, cap "
                  f"{K2_FLIP_SHARE})")
            worst32, worst16 = max(worst32, e32), max(worst16, e16)
        del x, x16, args, args16, allowance
        torch.cuda.empty_cache()
    return worst32, worst16, splits_by_shape


def phase_zoo_kernels(dev, card, paths):
    """K1, K2 and K3 at the shapes that the trainer's evaluations of `paths`
    (phases 26-34, 41-44 and 49-51) launch them at (phases 26-30: batch 2 at
    544x960, K2 at 4 in the siamese trunks; CFNet's K3 at batch 1; FADNet's
    K1 at 10; the IGEV family's K3 at its configs' batches 10, 8, 4 and 4, K2
    at twice those in the trunk; FoundationStereo's and
    FastFoundationStereo's cosine K3 at b1, MonSter's K3 at b8), and K1 at
    CoEx's config's evaluation batch of 10: the checks of phases 3, 4 and 9
    (`cosine_k3_check` where K3 takes divisor 1); then K1 at both batch-10
    shapes timed (`k1_eval_timing`) and K3 and K2 at the IGEV family's and
    phases 49-51's shapes (`trainer_eval_timing`)."""
    import torch

    g = torch.Generator().manual_seed(10)
    want = {"corr_volume": set(K1_EVAL10_SHAPES), "gwc_volume": set(), "fused_mbconv": set()}
    for path in paths:
        for kernel, shapes in path.want.items():
            want[kernel].update(shapes)
    k1 = {s: check_volume_kernel(dev, "corr_volume", s, g, "[zoo-eval] K1")
          for s in sorted(want["corr_volume"])}
    # a shape with K3's divisor (the cosine volumes) is checked on group-normalised features
    # against the plain cosine builder, with the unrounded control
    k3 = {s: cosine_k3_check(dev, s, g, "[zoo-eval] K3 cosine") if len(s) > 6
          else check_volume_kernel(dev, "gwc_volume", s, g, "[zoo-eval] K3")
          for s in sorted(want["gwc_volume"])}
    k2 = check_k2_shapes(dev, sorted(want["fused_mbconv"], reverse=True), g, "[zoo-eval]")
    print(f"[zoo-eval] K2 launcher split counts: {k2[2]}")
    k1_eval10 = [dict(k1_eval_timing(dev, s, dt, card, g), **dict(zip(VOLUME_ERR_KEYS, k1[s])))
                 for s, dt in K1_EVAL10_SHAPES.items()]
    return {"corr_volume": k1, "gwc_volume": k3, "fused_mbconv": k2, "k1_eval10": k1_eval10,
            "trainer_eval": trainer_eval_timing(dev, card, g, paths)}


def trainer_eval_timing(dev, card, g, paths):
    """K3 and K2 timed beside their bounds (bf16, `k3_timing`, `k2_timing`) at
    each shape the IGEV family's and phases 49-51's trainer evaluations
    launch them at (phases 41-44, 49-51): K3 per model, K2 per batch of the
    siamese trunk (IGEV-RT's 16, IGEV's 20, StereoBase's and IGEV++'s 8,
    timed once; phases 49-51 launch none); each record per evaluation batch,
    with the models that launch it."""
    import torch

    batches = {**IGEV_FAMILY_EVAL_BATCH, **FS_FAMILY_EVAL_BATCH}
    out = {"gwc_volume": {}, "fused_mbconv": {}}
    for path in paths:
        if path.name not in batches:
            continue
        b = batches[path.name]
        out["gwc_volume"][path.name] = dict(
            k3_timing(dev, path.want["gwc_volume"], card, g,
                      tag=f"K3 ({path.name} evaluation, b{b})"), batch=b)
        if "fused_mbconv" not in path.want:
            continue
        key = f"b{2 * b} trunk"
        if key not in out["fused_mbconv"]:
            out["fused_mbconv"][key] = dict(
                k2_timing(dev, path.want["fused_mbconv"], card, g,
                          tag=f"K2 (IGEV-family evaluation, trunk at b{2 * b})"), models=[])
        out["fused_mbconv"][key]["models"].append(path.name)
        torch.cuda.empty_cache()
    return out


def k1_eval_timing(dev, shape, dtype, card, g):
    """K1 at `shape` (B, C, H, W, D) in `dtype` ("f32", TF32 off, or "bf16"):
    CUDA events over back-to-back launches, device ms per launch
    (torch.profiler), the plain version, and the bound at that type's rates
    (`bound`, `bound_f32`)."""
    import torch

    from openstereo_tpu_torch import ops

    b, c, h, w, d = shape
    left, right = (torch.randn(b, c, h, w, generator=g).to(
        dev, {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]) for _ in range(2))
    kernel = lambda: ops.corr_volume(left, right, d)  # noqa: E731
    nbytes, flops = k1_work(shape, left.element_size())
    t_b, by = (bound if dtype == "bf16" else bound_f32)(nbytes, flops, card)
    rec = dict(shape=list(shape), dtype=dtype, ms=time_ms(kernel), device_ms=device_ms(kernel),
               plain_ms=time_ms(lambda: ops.correlation_volume(left, right, d), iters=10),
               bound_ms=t_b, bound_by=by, bytes=nbytes, flops=flops)
    print(f"[time] [zoo-eval] K1 {shape} {dtype}: kernel {rec['ms']:.4f} ms (CUDA events over "
          f"back-to-back launches), device {rec['device_ms']:.4f} ms per launch (torch.profiler), "
          f"plain {rec['plain_ms']:.4f} ms, bound {t_b:.4f} ms ({by}; {nbytes} B, {flops} flop; "
          f"{t_b / rec['device_ms']:.1%} of the device time)")
    del left, right
    torch.cuda.empty_cache()
    return rec


def zoo_eval(trainer, use_kernels, dtype=None, hook_module=None, deterministic=True,
             cudnn=True):
    """The trainer's evaluation set through its model in eval under
    `torch.inference_mode()` and, with `deterministic`, cuDNN's deterministic
    algorithms (without `cudnn`, PyTorch's own convolutions), with kernels or
    eager, in the model's compute dtype or `dtype`: the disparities [N,H,W] (f32) and, with
    `hook_module`, that module's outputs."""
    import torch

    from openstereo_tpu_torch.data.loader import batch_to_device
    from openstereo_tpu_torch.models import set_kernels

    model = trainer.model
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled
    saved_dtype, model.dtype = model.dtype, dtype or model.dtype
    set_kernels(model.eval(), use_kernels)
    # cuDNN's deterministic algorithms: under its default choice two eager runs of the
    # same weights differ by rounding, which CFNet's floored sample grids turn into
    # whole-disparity moves at some pixels (its phase prints the control); that would be
    # laid to the kernels' account
    torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = deterministic, cudnn
    outs, disps = [], []
    hook = (model.get_submodule(hook_module).register_forward_hook(
        lambda mod, inp, out: outs.append(out.float())) if hook_module else None)
    try:
        with torch.inference_mode():
            for batch in trainer.eval_loader.epoch(0):
                disps.append(model(batch_to_device(batch, trainer.device))["disp_pred"].float())
    finally:
        if hook is not None:
            hook.remove()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = saved
        model.dtype = saved_dtype
        set_kernels(model, True)
    return torch.cat(disps), outs


def zoo_eval_agreement(name, trainer, topk_input, rule="max_abs"):
    """The trainer's evaluation with kernels against the same weights run eager,
    both under cuDNN's deterministic algorithms (`zoo_eval`; for CFNet two
    eager runs under its default choice are printed beside, as the control),
    under the model's rule of phases 10-11 and 16-22: finite disparities, and
    by `rule`: "max_abs", f32 max-abs <= 5e-3 px; "share" (CFNet, whose sample
    grids are floors), f32 >= 99.9 % of the pixels within 5e-3 px; "share_f32"
    (the IGEV family, trained and evaluated in bf16: the GRU iterations carry
    a one-ulp difference forward) the same share with both paths run again in
    f32 (TF32 off) at the same batch (through PyTorch's own convolutions, at
    batch 1 cuDNN's deterministic algorithms), and the bf16 paths'
    mean-abs <= IGEV_FAMILY_BF16_MEAN_ABS; "finite"
    (the cascades: no kernel on the path) nothing more; for CoEx (`topk_input`:
    bf16, a top-k head) the f32 share within 5e-3 px >= 0.999, and in bf16 the
    cost feeding the top-k head within 2^-7 of its largest magnitude on
    average and the kernel path's disparity no more than 5 % further from the
    f32 eager one than the eager path's."""
    import torch

    tag = f"[{name.lower()}-train]"
    wired, costs_k = zoo_eval(trainer, True, hook_module=topk_input)
    eager, costs_e = zoo_eval(trainer, False, hook_module=topk_input)
    check(bool(torch.isfinite(wired).all()) and bool(torch.isfinite(eager).all()),
          f"{name} evaluation disparities not finite")
    rec = {"max_abs": float((wired - eager).abs().max()),
           "share_within_5e-3": float(((wired - eager).abs() <= 5e-3).float().mean())}
    if rule == "finite":
        print(f"{tag} evaluation ({trainer.model.dtype}, no kernel on the path): finite; kernels "
              f"vs eager max-abs {rec['max_abs']:.3g} px")
        return rec
    if rule == "share_f32":
        # f32 through PyTorch's own convolutions: at the configs' batches cuDNN's heuristics pick
        # FFT-tiled f32 convolutions (TF32 off), millions of small complex GEMMs and 32-125 s a
        # pass; without cuDNN a pass takes 0.4-3.4 s. At batch 1 cuDNN picks no FFT tiling, and
        # PyTorch's own 3D conv would unfold FoundationStereo's 7x7x7 classifier into ~30 GB
        f32_cudnn = trainer.eval_loader.batch_size == 1
        t0 = time.perf_counter()
        w32, _ = zoo_eval(trainer, True, torch.float32, cudnn=f32_cudnn)
        e32, _ = zoo_eval(trainer, False, torch.float32, cudnn=f32_cudnn)
        rec["f32_passes_s"] = time.perf_counter() - t0
        rec["share_within_5e-3_f32"] = float(((w32 - e32).abs() <= 5e-3).float().mean())
        rec["max_abs_f32"] = float((w32 - e32).abs().max())
        rec["mean_abs"] = float((wired - eager).abs().mean())
        print(f"{tag} evaluation kernels vs eager: f32 (TF32 off) "
              f"{rec['share_within_5e-3_f32']:.6f} of the pixels within 5e-3 px (tol >= 0.999), "
              f"max-abs {rec['max_abs_f32']:.3g} px "
              f"({'cuDNN' if f32_cudnn else 'PyTorch'}'s own convolutions, both passes "
              f"{rec['f32_passes_s']:.1f} s); "
              f"{trainer.model.dtype} mean-abs {rec['mean_abs']:.4g} px (tol "
              f"{IGEV_FAMILY_BF16_MEAN_ABS}), max-abs {rec['max_abs']:.3g} px")
        check(rec["share_within_5e-3_f32"] >= 0.999, f"{name} f32 evaluation kernels vs eager: "
                                                     f"only {rec['share_within_5e-3_f32']} within "
                                                     f"5e-3 px")
        check(rec["mean_abs"] <= IGEV_FAMILY_BF16_MEAN_ABS,
              f"{name} evaluation kernels vs eager mean-abs {rec['mean_abs']} px > "
              f"{IGEV_FAMILY_BF16_MEAN_ABS}")
        return rec
    if rule == "share":
        # the control that shows why both paths run cuDNN's deterministic algorithms: two
        # eager runs under its default choice (no check)
        again = [zoo_eval(trainer, False, deterministic=False)[0] for _ in range(2)]
        rec["eager_default_cudnn_share"] = float(((again[0] - again[1]).abs() <= 5e-3)
                                                 .float().mean())
        print(f"{tag} evaluation kernels vs eager ({trainer.model.dtype}): "
              f"{rec['share_within_5e-3']:.6f} of the pixels within 5e-3 px (tol >= 0.999), "
              f"max-abs {rec['max_abs']:.3g} px, bit-equal {bool(torch.equal(wired, eager))}; "
              f"eager vs eager under cuDNN's default algorithms: "
              f"{rec['eager_default_cudnn_share']:.6f} within 5e-3 px, bit-equal "
              f"{bool(torch.equal(*again))}")
        check(rec["share_within_5e-3"] >= 0.999, f"{name} evaluation kernels vs eager: only "
                                                 f"{rec['share_within_5e-3']} within 5e-3 px")
        return rec
    if topk_input is None:
        print(f"{tag} evaluation kernels vs eager ({trainer.model.dtype}): max-abs "
              f"{rec['max_abs']:.3g} px (tol 5e-3)")
        check(rec["max_abs"] <= 5e-3, f"{name} evaluation kernels vs eager max-abs "
                                      f"{rec['max_abs']} px > 5e-3")
        return rec
    w32, _ = zoo_eval(trainer, True, torch.float32)
    e32, _ = zoo_eval(trainer, False, torch.float32)
    rec["share_within_5e-3_f32"] = float(((w32 - e32).abs() <= 5e-3).float().mean())
    rec["cost_mean_abs_rel_bf16"] = max(float((a - b).abs().mean() / b.abs().max())
                                        for a, b in zip(costs_k, costs_e))
    rec["to_f32"] = {k: float((d - e32).abs().mean()) for k, d in (("kernels", wired),
                                                                    ("eager", eager))}
    print(f"{tag} evaluation kernels vs eager: f32 share within 5e-3 px "
          f"{rec['share_within_5e-3_f32']:.6f} (tol >= 0.999); bf16 cost feeding the top-k head "
          f"({topk_input}) mean-abs {rec['cost_mean_abs_rel_bf16']:.3g} of its largest magnitude "
          f"(tol 2^-7); bf16 vs the f32 eager disparity, mean-abs: kernels "
          f"{rec['to_f32']['kernels']:.4g} px, eager {rec['to_f32']['eager']:.4g} px (tol 5 % "
          f"further); bf16 max-abs kernels vs eager {rec['max_abs']:.3g} px")
    check(rec["share_within_5e-3_f32"] >= 0.999,
          f"{name} f32 evaluation: only {rec['share_within_5e-3_f32']} within 5e-3 px")
    check(rec["cost_mean_abs_rel_bf16"] <= 2 ** -7,
          f"{name} bf16 top-k input: mean-abs {rec['cost_mean_abs_rel_bf16']}·max|cost| > 2^-7")
    check(rec["to_f32"]["kernels"] <= 1.05 * rec["to_f32"]["eager"],
          f"{name} bf16 kernel path {rec['to_f32']['kernels']} px from the f32 disparity, the "
          f"eager path {rec['to_f32']['eager']} px: more than 5 % further")
    return rec


@contextmanager
def cudnn_deterministic(on):
    """cuDNN's deterministic algorithms within it when `on`."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on or before
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@contextmanager
def cudnn_tf32(on):
    """cuDNN's f32 convolutions may use TF32 (PyTorch's default) or not (this
    script's default, for its f32 checks) within it."""
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def step_grads(model, batch):
    """One training forward, loss and backward: (loss, {name: gradient in f64})
    for every parameter that got one."""
    import torch

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    torch.cuda.synchronize()
    grads = {k: p.grad.detach().double() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def grads_within(g32, g64, rel, floor):
    """Whether `g32` holds every tensor of `g64` and nothing else, each within
    `rel`·max|g| of the tensor + `floor`·max|g| of the model: (ok, the worst
    (name, error / that bound), the worst (name, error / max|g| of the
    tensor) over tensors above 1e-4 of the largest gradient, the worst (name,
    error / max|g| of the model), the missing and the extra names, and the
    worst (name, rel needed beyond the floor: (error - floor·max|g| of the
    model) / max|g| of the tensor, 0 where the floor covers the error))."""
    missing, extra = sorted(set(g64) - set(g32)), sorted(set(g32) - set(g64))
    gmax = max(g.abs().max().item() for g in g64.values())
    ratio, of_tensor, of_model, needed = {}, {}, {}, {"": 0.0}
    for k in set(g64) & set(g32):
        scale = g64[k].abs().max().item()
        err = (g32[k] - g64[k]).abs().max().item()
        ratio[k] = err / (rel * scale + floor * gmax)
        of_model[k] = err / gmax
        if scale > 1e-4 * gmax:
            of_tensor[k] = err / scale
        if err > floor * gmax:
            needed[k] = (err - floor * gmax) / scale if scale > 0 else float("inf")

    def worst(d):
        k = max(d, key=d.get)
        return k, d[k]

    ok = not missing and not extra and worst(ratio)[1] <= 1.0
    return ok, worst(ratio), worst(of_tensor), worst(of_model), missing, extra, worst(needed)


def zoo_grad_check(dev, path):
    """One step of the config's model of `path` (a `ZooPath`; flax's
    initialisation, seed 1) at batch 1 and `path.grad_hw` on a random-dot pair,
    in f32 with TF32 off against the same step in f64 on the card: every
    parameter that gets a gradient in f64 gets one in f32, each within the
    bound (`path.rel` of the tensor's largest magnitude + ZOO_GRAD_FLOOR of
    the model's largest gradient; `zoo_train_paths` says why). The step under
    `path.control` must fail the check: the features detached before the
    volume (`detached_volume`) or the IGEV family's GRU loop without its
    detach (`undetached`)."""
    import copy

    import torch

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.models import build_model
    from openstereo_tpu_torch.tools.overfit_check import MEAN, STD, make_stereogram

    name, bound = path.name, (path.rel, ZOO_GRAD_FLOOR)
    h, w = path.grad_hw
    left, right, disp = make_stereogram(np.random.RandomState(5), h, w, 64)
    img = lambda a: torch.from_numpy(((a / 255 - MEAN) / STD).astype(np.float32)  # noqa: E731
                                     ).permute(2, 0, 1)[None].to(dev)
    batch = {"left": img(left), "right": img(right), "disp": torch.from_numpy(disp)[None].to(dev)}
    model = build_model(load_config(str(path.cfg)).MODEL, dtype=torch.float32, device=dev,
                        seed=1, init="train")
    m64 = copy.deepcopy(model).double()
    m64.dtype = torch.float64
    t0 = time.perf_counter()
    loss64, g64 = step_grads(m64, {k: v.double() for k, v in batch.items()})
    t64 = time.perf_counter() - t0
    del m64
    loss32, g32 = step_grads(model, batch)
    ok, worst, of_tensor, of_model, missing, extra, needed = grads_within(g32, g64, *bound)
    with path.control(model, path.targets):
        _, g_ctl = step_grads(model, batch)
    ctl_ok, ctl_worst, _, _, ctl_missing, _, ctl_needed = grads_within(g_ctl, g64, *bound)
    gmax = max(g.abs().max().item() for g in g64.values())
    top = sorted(((g32[k] - g64[k]).abs().max().item() / gmax, k, g64[k].abs().max().item() / gmax)
                 for k in g64 if k in g32)[-6:]
    # the rel at which every tensor's bound, floor included, holds twice its f32 error (the rule
    # the bounds of phases 31-34, 41-44 and 49-51 were set by, over 3 runs)
    twice = max([0.0] + [(2 * (g32[k] - g64[k]).abs().max().item() - ZOO_GRAD_FLOOR * gmax)
                         / g64[k].abs().max().item() for k in g64
                         if k in g32 and g64[k].abs().max().item() > 0])
    del model, g32, g_ctl
    torch.cuda.empty_cache()
    print(f"[{name.lower()}-grad] one step at b1 {h}x{w}: loss f32 {loss32:.6f}, f64 {loss64:.6f} "
          f"(f64 step {t64:.1f} s); {len(g64)} gradients; f32 vs f64 worst "
          f"{of_tensor[1]:.3g}·max|g| of the tensor at {of_tensor[0]} (tensors above 1e-4 of the "
          f"largest), worst {of_model[1]:.3g}·max|g| of the model at {of_model[0]}; against the "
          f"bound ({bound[0]}·max|g| of the tensor + {bound[1]}·max|g| of the model) worst "
          f"{worst[1]:.3g} at {worst[0]} (tol 1); rel needed beyond the floor {needed[1]:.3g} at "
          f"{needed[0] or '-'}, for twice each error {twice:.3g}; missing {missing}, extra "
          f"{extra}; {path.control.__name__} control: "
          f"{len(ctl_missing)} tensors without a gradient, worst {ctl_worst[1]:.3g} of the bound "
          f"at {ctl_worst[0]}, rel needed {ctl_needed[1]:.3g} at {ctl_needed[0] or '-'}, rejected "
          f"{not ctl_ok}; largest errors (of max|g| of the model, "
          f"tensor, its max|g| of the model's): "
          + "; ".join(f"{e:.3g} {k} {sc:.3g}" for e, k, sc in reversed(top)))
    check(ok, f"{name} f32 gradients vs f64: worst {worst} of the bound, missing {missing}, "
              f"extra {extra}")
    check(not ctl_ok, f"{name}: the {path.control.__name__} control passes the gradient check")
    return {"loss_f32": loss32, "loss_f64": loss64, "worst_of_tensor": of_tensor,
            "worst_of_model": of_model, "worst_of_bound": worst, "bound": list(bound),
            "rel_needed": needed, "rel_for_twice": twice, "control_rel_needed": ctl_needed,
            "tensors": len(g64), "control_missing": len(ctl_missing),
            "control_worst_of_bound": ctl_worst, "f64_step_s": t64}


def phase_zoo_train(dev, paths, grads):
    """Phases 26-34 (`paths`, of `zoo_train_paths`) on the first
    ZOO_TRAIN_PAIRS + ZOO_CFG_EVAL_PAIRS pairs of `sceneflow_set` (the
    runs' checkpoints deleted afterwards), each with its gradient check's
    result from `grads` (`phase_beside_build`)."""
    import shutil

    shutil.rmtree(ZOO_TRAIN_DIR, ignore_errors=True)
    data_root, lines = sceneflow_set()
    try:
        out = {}
        for path in paths:
            t1 = time.perf_counter()
            out[path.name] = run_zoo_training(
                dev, path, data_root, lines[:ZOO_TRAIN_PAIRS],
                lines[ZOO_TRAIN_PAIRS:ZOO_TRAIN_PAIRS + path.eval_pairs])
            out[path.name]["grad_check"] = grads[path.name]
            out[path.name]["seconds"] = time.perf_counter() - t1
            print(f"[phase-time] {path.name} training: {out[path.name]['seconds']:.1f} s")
        return out
    finally:
        for ckpt in ZOO_TRAIN_DIR.glob("**/ckpt"):
            shutil.rmtree(ckpt, ignore_errors=True)


def run_zoo_training(dev, path, data_root, train_lines, eval_lines):
    """One of phases 26-34 (`path`, a `ZooPath`): `tools/train.py` on the
    model's SceneFlow config as it is (its crop, batch, dtype, optimizer,
    schedule with warm-up and clip) but for the data paths, NUM_EPOCHS 1 over
    4 batches of the synthetic set and the evaluation of `eval_lines` at the
    path's batch (phases 26-30: 2; 31-34: the config's) and the config's pad.
    The evaluation must launch `path.want` per batch and nothing else may
    launch in the run; then the evaluation against eager
    (`zoo_eval_agreement`), for GwcNet a resumed Trainer, and 4 timed train
    steps (forward, backward, optimizer; no launch), 1 profiled one, with
    `path.remat` 4 with MODEL.REMAT and with `path.tf32_off_timing` (an f32
    config) 2 with TF32 off."""
    import torch
    import yaml

    from openstereo_tpu_torch.config import Config
    from openstereo_tpu_torch.data.loader import batch_to_device
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.runtime import Trainer
    from openstereo_tpu_torch.tools import train

    name, cfg_file, want = path.name, path.cfg, path.want
    tag = f"[{name.lower()}-train]"
    run_dir = ZOO_TRAIN_DIR / name.lower()
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = yaml.safe_load(cfg_file.read_text())
    opt = cfg["OPTIMIZATION"]
    bsz = opt["BATCH_SIZE_PER_GPU"]
    split = {"train": run_dir / "train.txt", "test": run_dir / "test.txt"}
    split["train"].write_text("\n".join(train_lines[:ZOO_STEPS * bsz]))
    split["test"].write_text("\n".join(eval_lines))
    info = cfg["DATA_CONFIG"]["DATA_INFOS"][0]
    info["DATA_SPLIT"] = {"TRAINING": str(split["train"]), "EVALUATING": str(split["test"]),
                          "TESTING": str(split["test"])}
    info["DATA_PATH"] = str(data_root)
    opt["NUM_EPOCHS"] = 1  # the cut: 4 steps
    eval_batch = path.eval_batch or cfg["EVALUATOR"]["BATCH_SIZE_PER_GPU"]
    cfg["EVALUATOR"]["BATCH_SIZE_PER_GPU"] = eval_batch
    cfg_path = run_dir / cfg_file.name
    cfg_path.write_text(yaml.safe_dump(cfg))
    paths = run_dir / "data_paths.yaml"
    paths.write_text(yaml.safe_dump({info["DATASET"]: str(data_root)}))
    crop = next(t["SIZE"] for t in cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["TRAINING"]
                if t["NAME"] == "RandomCrop")
    dtype = "bf16" if opt["AMP"] else "f32"
    pad = cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]
    print(f"{tag} config: crop {crop}, batch {bsz}, {dtype}, {opt['OPTIMIZER']['NAME']} "
          f"{opt['OPTIMIZER']['LR']}, {opt['SCHEDULER']['NAME']} warm-up "
          f"{opt['SCHEDULER'].get('WARMUP')}, clip {opt.get('CLIP_GRAD')}, FREEZE_BN "
          f"{opt.get('FREEZE_BN', False)}, NUM_EPOCHS 1 ({ZOO_STEPS} steps); evaluation of "
          f"{len(eval_lines)} pairs at batch {eval_batch}, {pad['NAME']} "
          f"{pad.get('SIZE', pad.get('BY'))}")

    # the run, its timed and profiled steps in PyTorch's default numerics (f32 convolutions
    # in TF32 on cuDNN), as tools/train.py runs for a user; the checks with TF32 off
    tf32 = dtype == "f32"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with cudnn_tf32(tf32):
        trainer = train.main(["--cfg_file", str(cfg_path), "--save_root", str(run_dir / "runs"),
                              "--data_paths", str(paths), "--workers", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    shapes = {k: dict(v) for k, v in kernels.launch_shapes.items()}
    peak_run = torch.cuda.max_memory_allocated(dev)
    steps, n_eval = trainer.state.step, trainer.eval_loader.steps_per_epoch
    check(steps == ZOO_STEPS and n_eval == len(eval_lines) // eval_batch,
          f"{name}: {steps} train steps, {n_eval} evaluation batches")
    losses, step_ms = trainer.epoch_losses, trainer.epoch_step_ms
    check(len(losses) == steps and all(np.isfinite(v) for v in losses), f"{name} losses {losses}")
    print(f"{tag} launches over the run ({steps} train steps, {n_eval} evaluation batches of "
          f"{eval_batch}): {launches}")
    for kernel, n in launches.items():
        per_batch = want.get(kernel, {})
        check(n == sum(per_batch.values()) * n_eval,
              f"{name}: {kernel} launched {n} times, not {sum(per_batch.values())} per "
              f"evaluation batch (and none in training)")
        check(shapes[kernel] == {k: c * n_eval for k, c in per_batch.items()},
              f"{name}: {kernel} launch shapes {shapes[kernel]} != {per_batch} per batch")
    ms = float(np.median(step_ms[1:ZOO_STEPS]))
    records = [json.loads(ln) for ln in open(trainer.metrics_file)]
    wired = [r for r in records if r["phase"] == "eval"][-1]
    check(all(np.isfinite(v) for k, v in wired.items() if k != "phase"), f"{name} {wired}")
    print(f"{tag} losses {[round(v, 4) for v in losses]}; step ms (CUDA events) "
          f"{[round(t, 2) for t in step_ms]}; median of steps 2-{ZOO_STEPS} {ms:.2f} ms/step, "
          f"{bsz / ms * 1e3:.2f} samples/s; peak memory over the run (max_memory_allocated) "
          f"{peak_run / 2**30:.3f} GiB; wall {wall:.1f} s; evaluation "
          f"{ {k: round(v, 4) for k, v in wired.items() if k not in ('phase', 'epoch')} }")
    agree = zoo_eval_agreement(name, trainer, path.topk_input, path.rule)

    if name == "GwcNet":
        check(trainer.saved_epochs() == [0], f"checkpoints {trainer.saved_epochs()}")
        saved = torch.load(trainer.ckpt_path(0), map_location="cpu", weights_only=True)
        again = Trainer(Config.from_dict(cfg), trainer.run_dir, device=dev, num_workers=8)
        start = again.resume_ckpt()
        state = again.model.state_dict()
        same = all(torch.equal(state[k].cpu(), v) for k, v in saved["model_state"].items())
        check(start == 1 and again.state.step == steps and same,
              f"resume: start epoch {start}, step {again.state.step}, bit-equal {same}")
        print(f"{tag} resumed Trainer: start epoch {start}, step {again.state.step}, "
              f"{len(saved['model_state'])} tensors bit-equal to the checkpoint")
        del again, saved

    took = {"train.py": wall, "evaluations": time.perf_counter() - t0 - wall}
    batches = trainer.train_loader.epoch(1)
    batch = batch_to_device(next(batches), dev)
    batches.close()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    with cudnn_tf32(tf32):
        times, peak = timed_train_steps(trainer, batch)
    check(sum(kernels.launch_counts.values()) == 0,
          f"{name}: the train steps launched {kernels.launch_counts}")
    split_ms = {k: float(np.median([t[i] for t in times[1:]]))
                for i, k in enumerate(("step", "forward", "backward", "optimizer"))}
    took["timed steps"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    label = f"{name} b{bsz} {crop[0]}x{crop[1]} {dtype}{' (TF32 convs)' if tf32 else ''}"
    with cudnn_tf32(tf32):
        prof = profile_train_steps(trainer, ms, batch, label=label,
                                   table=run_dir / "profile_train_step.txt")
    took["profile"] = time.perf_counter() - t1
    rec = {"ms_per_step": ms, "samples_per_s": bsz / ms * 1e3, "step_ms": step_ms,
           "losses": losses, "peak_bytes_run": peak_run, "peak_bytes_train": peak,
           "split_ms": split_ms, "profile": prof, "eval_kernels": wired, "agreement": agree,
           "launches": launches, "eval_batches": n_eval, "eval_batch": eval_batch, "batch": bsz,
           "crop": crop, "dtype": dtype + (" (cuDNN TF32)" if tf32 else "")}
    line = (f"{tag} 4 timed steps: {split_ms['step']:.2f} ms/step (median of steps 2-4), forward "
            f"+ loss {split_ms['forward']:.2f} ms, backward {split_ms['backward']:.2f} ms, "
            f"optimizer {split_ms['optimizer']:.2f} ms; no kernel launched; peak memory "
            f"{peak / 2**30:.3f} GiB")
    t1 = time.perf_counter()
    if path.remat:
        trainer.model.remat = True
        with cudnn_tf32(tf32):
            times_r, peak_r = timed_train_steps(trainer, batch)
        trainer.model.remat = False
        rec["remat"] = {"ms_per_step": float(np.median([t[0] for t in times_r[1:]])),
                        "peak_bytes": peak_r}
        line += (f"; with MODEL.REMAT {rec['remat']['ms_per_step']:.2f} ms/step, peak "
                 f"{peak_r / 2**30:.3f} GiB")
    if tf32 and path.tf32_off_timing:
        # 2 steps, the second timed (cut from 4 for the script's time)
        times_t, peak_t = timed_train_steps(trainer, batch, steps=2)
        rec["no_tf32"] = {"ms_per_step": times_t[1][0], "peak_bytes": peak_t}
        line += (f"; with TF32 off (f32 convolutions throughout) "
                 f"{rec['no_tf32']['ms_per_step']:.2f} ms/step (the second of 2 steps), peak "
                 f"{peak_t / 2**30:.3f} GiB")
    if path.remat or (tf32 and path.tf32_off_timing):
        took["remat and TF32-off steps"] = time.perf_counter() - t1
    rec["took_s"] = took
    print(line + "; seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in took.items()))
    del trainer, batch
    torch.cuda.empty_cache()
    return rec


def zoo_train_summary(zoo, overfits):
    lines = []
    for name, r in zoo.items():
        p, gc = r["profile"], r["grad_check"]
        remat = (f", MODEL.REMAT peak {r['remat']['peak_bytes'] / 2**30:.3f} GiB at "
                 f"{r['remat']['ms_per_step']:.2f} ms/step" if "remat" in r else "")
        if "no_tf32" in r:
            remat += f", TF32 off {r['no_tf32']['ms_per_step']:.2f} ms/step"
        lines.append(
            f"[zoo-train] {name} {r['crop'][0]}x{r['crop'][1]} b{r['batch']} {r['dtype']}: "
            f"{r['ms_per_step']:.2f} ms/step, {r['samples_per_s']:.2f} samples/s, peak "
            f"{r['peak_bytes_train'] / 2**30:.3f} GiB{remat}; forward "
            f"{r['split_ms']['forward']:.2f} / backward {r['split_ms']['backward']:.2f} / optimizer "
            f"{r['split_ms']['optimizer']:.2f} ms; device busy "
            f"{p['device_busy_ms_per_step']:.2f} ms/step, idle {p['idle_share']:.4f} "
            f"(traced {p['idle_share_traced']:.4f}); evaluation (b{r['eval_batch']}) EPE "
            f"{r['eval_kernels']['epe']:.4f} px; gradient f32 vs f64 worst "
            f"{gc['worst_of_tensor'][1]:.3g}·max|g| of the tensor, "
            f"{gc['worst_of_model'][1]:.3g} of the model's; {r['seconds']:.1f} s")
    for name, res in overfits.items():
        lines.append(f"[zoo-train] {name} overfit loss ratio {res['loss_ratio']:.4f}")
    return "\n".join(lines)


def trainer_eval_launches(trained, zoo, kernel):
    """A kernel's launches in the trainer's evaluations, by model: LightStereo-S
    (phase 14, batch 12) and phases 26-34 (batch 2 in 26-30, the configs' in
    31-34), with the batches run."""
    out = {"LightStereo": dict(launches=trained["launches"][kernel],
                               batches=trained["eval_batches"], batch=EVAL_BATCH)}
    for name, r in zoo.items():
        if r["launches"][kernel]:
            out[name] = dict(launches=r["launches"][kernel], batches=r["eval_batches"],
                             batch=r["eval_batch"])
    return out


def volume_checks(errs):
    """K1/K3 checks of `phase_zoo_kernels` as JSON: one entry per shape."""
    return [dict(shape=list(shape), **dict(zip(VOLUME_ERR_KEYS, e))) for shape, e in errs.items()]


def path_entries(models, kernel, errors):
    """The `paths` field of a kernel's JSON entry: for each path of `model_paths`
    that launched it, the launches counted on that path's run, per frame by
    shape, the times per frame at those shapes (`k1/k2/k3_timing`) and the
    errors at those shapes from the kernel phases."""
    out = {}
    for name, rec in models.items():
        if kernel not in rec["per_frame"]:
            continue
        t = rec["kernels"][kernel]
        out[name] = dict(launches=rec["launches"][kernel],
                         launches_per_frame=t["launches_per_frame"],
                         **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "yardstick_ms",
                                              "bound_ms", "bound_by", "shapes") if k in t},
                         **errors.get(name, {}))
    return out


def igev_path():
    """IGEV-Stereo's inference path, as a `model_paths` entry: the SceneFlow
    config at its 544x960 pad, K3 once a frame at C/G 12 and K2 11 times (its
    trunk is CoEx's), the f32 rule "share" (32 GRU iterations carry a
    one-ulp difference forward: >= 99.9 % of the pixels within 5e-3 px, the
    max-abs printed), 2 timing groups of 3 frames (~0.7 s a group), 1 frame
    profiled (~12,000 device operations a frame; reading them took ~5 s
    through `key_averages()`, 0.3 s through `device_rows`)."""
    return ("IGEV", IGEV_CFG, {"gwc_volume": {IGEV_K3_SHAPE: 1}, "fused_mbconv": COEX_K2_SHAPES},
            "share", (2, 3, 1))


def igev_family_paths():
    """IGEV-RT, StereoBase and IGEV++ (phases 38-40), as `model_paths` entries:
    each SceneFlow config at its 544x960 pad, full width and depth (IGEV-RT 8
    iterations, StereoBase 32, IGEV++ 32), K2 11 times a frame in IGEV's
    trunk and K3 once: [1,96,136,240] D 48 G 8 in IGEV-RT and StereoBase,
    D 192 in IGEV++; the f32 rule "share" (the GRU iterations carry a
    one-ulp difference forward), 2 timing groups (IGEV-RT's of 8 frames,
    the others' of 3) and 1 frame profiled."""
    trunk = COEX_K2_SHAPES
    return [
        ("IGEV-RT", IGEV_RT_CFG, {"gwc_volume": {IGEV_K3_SHAPE: 1}, "fused_mbconv": trunk},
         "share", (2, 8, 1)),
        ("StereoBase", STEREOBASE_CFG, {"gwc_volume": {IGEV_K3_SHAPE: 1}, "fused_mbconv": trunk},
         "share", (2, 3, 1)),
        ("IGEV++", IGEVPP_CFG, {"gwc_volume": {IGEVPP_K3_SHAPE: 1}, "fused_mbconv": trunk},
         "share", (2, 3, 1)),
    ]


def foundationstereo_paths():
    """FoundationStereo and FastFoundationStereo (phases 46-47), as `model_paths`
    entries: each config at full width and depth (vitl, D/4 104, 32 iterations
    of the three-scale selective GRU; 8 of one scale) at 544x960 b1 bf16, the
    cosine volume through K3 with divisor 1 once a frame and no other kernel;
    the f32 rule "deterministic" (max-abs 5e-3 px with cuDNN's deterministic
    algorithms: K3's f32 sum is bit-equal to the plain one); 2 timing groups
    (of 2 and 4 frames) and 1 frame profiled."""
    return [
        ("FoundationStereo", FS_CFG, {"gwc_volume": {FS_K3_SHAPE: 1}}, "deterministic", (2, 2, 1)),
        ("FastFoundationStereo", FFS_CFG, {"gwc_volume": {FFS_K3_SHAPE: 1}}, "deterministic",
         (2, 4, 1)),
    ]


def monster_path():
    """MonSter (phase 48), as a `model_paths` entry: its SceneFlow config at
    full width and depth (vits, 32 iterations of which 7 mutual) at 544x960
    b1 bf16, K3 once a frame at IGEV's shape and no other kernel; the f32
    rule "deterministic" (K3's f32 sum at C/G 12 is bit-equal to the plain
    one); 2 timing groups of 2 frames and 1 frame profiled."""
    return ("MonSter", MONSTER_CFG, {"gwc_volume": {IGEV_K3_SHAPE: 1}}, "deterministic",
            (2, 2, 1))


def phase_gru_model(dev, card, path, label, measure_reps=None):
    """A GRU model's path through `run_pair` as phases 16-22 run theirs
    (`phase_model`, `phase_timing_model`), then, with `measure_reps`, the
    measure CLI on the card (parameters, FLOPs, ms/frame beside the card's
    name and power limit)."""
    import torch

    from openstereo_tpu_torch.tools import measure

    name, cfg_file, want, rule, protocol = path
    t0 = time.perf_counter()
    model, rec = phase_model(dev, name, cfg_file, want, rule)
    t1 = time.perf_counter()
    rec["bench"], rec["profile"], rec["kernels"] = phase_timing_model(
        dev, name, model, card, rec["per_frame"], protocol, tuple(rec["size"]))
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    if measure_reps:
        rec["measure"] = measure.main(["--cfg_file", str(cfg_file), "--reps", str(measure_reps),
                                       "--warmup", "3"])
    print(f"[phase-time] {label}: agreement {t1 - t0:.1f} s, timing and profile {t2 - t1:.1f} s, "
          f"measure CLI {time.perf_counter() - t2:.1f} s")
    return rec


def phase_igev(dev, card):
    """Phase 36: IGEV through `run_pair`, then the measure CLI (`phase_gru_model`)."""
    return phase_gru_model(dev, card, igev_path(), "36 IGEV", measure_reps=10)


def kitti_pair(root, hw, max_disp, i):
    """Random-dot stereogram `i` in the KITTI 2015 layout (`write_kitti_set`)."""
    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
    name = f"{i:06d}_10.png"
    for sub, img in (("image_2", left), ("image_3", right)):
        save_png(np.clip(np.round(img), 0, 255).astype(np.uint8), root / "training" / sub / name)
    save_png(np.round(disp * 256.0).astype(np.uint16), root / "training/disp_occ_0" / name)
    return f"training/image_2/{name} training/image_3/{name} training/disp_occ_0/{name}"


def write_kitti_set(root, n, hw, max_disp=192):
    """`n` random-dot stereograms (`make_stereogram`, seeds 0..n-1) in the KITTI
    2015 layout: training/image_2, image_3 PNG and disp_occ_0 uint16 PNG of
    disparity × 256; returns the split lines."""
    import functools

    for sub in ("image_2", "image_3", "disp_occ_0"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    return write_pairs(functools.partial(kitti_pair, root, hw, max_disp), range(n))


def phase_igev_eval(dev, card):
    """Phase 37: K2 at the KITTI evaluation's trunk shapes (batch 8) against
    its plain version (phase 4's checks) and timed beside its bound, K3 at
    [4,96,96,312] D 48 G 8 timed (checked in phase 9); then the port's eval
    CLI (`tools/eval.py`) with IGEV's SceneFlow config and
    `cfgs/kitti15_eval.yaml` on IGEV_EVAL_PAIRS synthetic KITTI-format pairs
    at 375x1242 (padded to 384x1248, batch 4, bf16, the trainer's seeded
    weights): the eval data config is the file's, its split pointed at the
    written set, and --data_paths maps KittiDataset to it. Per batch K3 1 and
    K2 11 at those shapes and nothing else; the same Trainer evaluated again
    eager; both runs' metrics printed and held to IGEV_EVAL_TOL. The set and
    the run directory are deleted afterwards."""
    import shutil

    import torch
    import yaml

    from openstereo_tpu_torch.models import set_kernels
    from openstereo_tpu_torch.ops import kernels
    from openstereo_tpu_torch.tools import eval as eval_cli

    g = torch.Generator().manual_seed(12)
    k2_err = check_k2_shapes(dev, IGEV_EVAL_K2_SHAPES, g, "[igev-eval]")
    print(f"[igev-eval] K2 launcher split counts: {k2_err[2]}")
    per_batch = {"gwc_volume": {IGEV_EVAL_K3_SHAPE: 1}, "fused_mbconv": IGEV_EVAL_K2_SHAPES}
    k2 = k2_timing(dev, IGEV_EVAL_K2_SHAPES, card, g, tag="K2 (IGEV evaluation, b4)")
    k3 = k3_timing(dev, per_batch["gwc_volume"], card, g, tag="K3 (IGEV evaluation, b4)")

    shutil.rmtree(IGEV_EVAL_DIR, ignore_errors=True)
    IGEV_EVAL_DIR.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        lines = write_kitti_set(IGEV_EVAL_DIR, IGEV_EVAL_PAIRS, KITTI_HW)
        split = IGEV_EVAL_DIR / "split.txt"
        split.write_text("\n".join(lines) + "\n")
        ecfg = yaml.safe_load(KITTI_EVAL_CFG.read_text())
        ecfg["DATA_CONFIG"]["DATA_INFOS"][0]["DATA_SPLIT"]["EVALUATING"] = str(split)
        (IGEV_EVAL_DIR / "kitti15_eval.yaml").write_text(yaml.safe_dump(ecfg))
        (IGEV_EVAL_DIR / "roots.yaml").write_text(yaml.safe_dump(
            {"KittiDataset": str(IGEV_EVAL_DIR)}))
        print(f"[igev-eval] wrote {len(lines)} KITTI-format pairs at {KITTI_HW[0]}x{KITTI_HW[1]} "
              f"in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer, wired = eval_cli.main([
            "--cfg_file", str(IGEV_CFG), "--eval_data_cfg_file",
            str(IGEV_EVAL_DIR / "kitti15_eval.yaml"), "--data_paths",
            str(IGEV_EVAL_DIR / "roots.yaml"), "--run_dir", str(IGEV_EVAL_DIR / "run")])
        torch.cuda.synchronize()
        s_kernels = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        shapes = {k: dict(kernels.launch_shapes[k]) for k in per_batch}
        batches = len(trainer.eval_loader)
        check(trainer.model.dtype == torch.bfloat16 and trainer.eval_loader.batch_size ==
              IGEV_EVAL_BATCH and batches == IGEV_EVAL_PAIRS // IGEV_EVAL_BATCH,
              f"IGEV evaluation: {trainer.model.dtype}, batch {trainer.eval_loader.batch_size}, "
              f"{batches} batches")
        for name, n in launches.items():
            want = {k: c * batches for k, c in per_batch.get(name, {}).items()}
            check(n == sum(want.values()), f"IGEV evaluation: {name} launched {n} times over "
                                           f"{batches} batches, not {sum(want.values())}")
            if want:
                check(shapes[name] == want, f"IGEV evaluation: {name} at {shapes[name]}, not "
                                            f"{want}")
        set_kernels(trainer.model, False)
        t0 = time.perf_counter()
        eager = trainer.evaluate(1)
        s_eager = time.perf_counter() - t0
        set_kernels(trainer.model, True)
        diff = {k: abs(wired[k] - eager[k]) for k in IGEV_EVAL_TOL}
        print(f"[igev-eval] {batches} batches of {IGEV_EVAL_BATCH} at 384x1248, bf16: launches "
              f"{launches}; metrics with kernels {wired} ({s_kernels:.1f} s with the Trainer's "
              f"set-up), eager {eager} ({s_eager:.1f} s); |difference| {diff} (tol "
              f"{IGEV_EVAL_TOL})")
        for k, tol in IGEV_EVAL_TOL.items():
            check(np.isfinite(wired[k]) and np.isfinite(eager[k]) and diff[k] <= tol,
                  f"IGEV evaluation {k}: kernels {wired[k]}, eager {eager[k]} (tol {tol})")
        del trainer
    finally:
        shutil.rmtree(IGEV_EVAL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"metrics_kernels": wired, "metrics_eager": eager, "launches": launches,
            "batches": batches, "batch": IGEV_EVAL_BATCH, "k2": k2, "k3": k3,
            "k2_max_abs_err_f32": k2_err[0], "k2_max_abs_err": k2_err[1],
            "k2_splits": [dict(shape=list(k), splits=v) for k, v in k2_err[2].items()]}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        import openstereo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pools = []  # worker process pools, stopped at the end
    try:
        smi, kind = run_phase("1 card", phase_card)
        card = peaks(kind)
        pool, futures = start_beside_build()
        pools.append(pool)
        ptxas = run_phase("2 build", phase_build)
        learned, grads = run_phase("2 checks beside the build", phase_beside_build, futures)
        pool.shutdown()  # the workers' card memory goes with them
        start_writers()  # the synthetic sets' writers, ready by phase 37
        k1_err = run_phase("3 K1", phase_k1, dev)
        k2_err = run_phase("4 K2", phase_k2, dev)
        k4_err = run_phase("5 K4", phase_k4, dev)
        model, launches, per_frame, max32, mean16 = run_phase("6 LightStereo", phase_slice, dev)
        sttr, k4_launches, k4_per_frame, sttr_agree = run_phase("7 STTR", phase_sttr, dev)
        bench, k1, k2 = run_phase("8 timing", phase_timing, dev, model, card, per_frame)
        sttr_bench, sttr_prof, k4 = run_phase("8 STTR timing", phase_timing_sttr, dev, sttr, card,
                                              k4_per_frame)
        del model, sttr
        torch.cuda.empty_cache()
        k3_err = run_phase("9 K3", phase_k3, dev)
        gwcnet, k3_launches, k3_per_frame, gwc_agree = run_phase("10 GwcNet", phase_gwcnet, dev)
        psmnet = run_phase("11 PSMNet", phase_psmnet, dev)
        gwc_bench, psm_bench, gwc_prof, k3 = run_phase("12 timing", phase_timing_3d, dev, gwcnet,
                                                       psmnet, card, k3_per_frame)
        del gwcnet, psmnet
        torch.cuda.empty_cache()
        models = {}
        for name, cfg_file, want, rule, protocol in model_paths():
            t1 = time.perf_counter()
            model, rec = phase_model(dev, name, cfg_file, want, rule)
            rec["bench"], rec["profile"], rec["kernels"] = phase_timing_model(
                dev, name, model, card, rec["per_frame"], protocol, tuple(rec["size"]))
            models[name] = rec
            del model
            torch.cuda.empty_cache()
            PHASE_SECONDS[f"16-22 {name}"] = time.perf_counter() - t1
            print(f"[phase-time] 16-22 {name}: {PHASE_SECONDS[f'16-22 {name}']:.1f} s")
        models["IGEV"] = run_phase("36 IGEV", phase_igev, dev, card)
        igev_eval = run_phase("37 IGEV eval CLI", phase_igev_eval, dev, card)
        for number, path in zip((38, 39, 40), igev_family_paths()):
            label = f"{number} {path[0]}"
            models[path[0]] = run_phase(label, phase_gru_model, dev, card, path, label,
                                        5 if path[0] == "IGEV++" else None)
        for number, path in zip((46, 47), foundationstereo_paths()):
            label = f"{number} {path[0]}"
            models[path[0]] = run_phase(label, phase_gru_model, dev, card, path, label,
                                        FS_MEASURE_REPS if path[0] == "FoundationStereo" else None)
        models["MonSter"] = run_phase("48 MonSter", phase_gru_model, dev, card, monster_path(),
                                      "48 MonSter")
        k1_eval, k2_eval, k2_eval_splits = run_phase("13 evaluation batch", phase_eval_batch, dev)
        trained = run_phase("14 LightStereo training", phase_train, dev)
        k4_train = run_phase("23 K4 under autograd", phase_k4_train, dev, card)
        sttr_trained = run_phase("24 STTR training", phase_sttr_train, dev, card, k4_train)
        sttr_overfit = run_phase("25 STTR overfit", phase_sttr_overfit)
        paths = zoo_train_paths()
        zoo_kernels = run_phase("26-34 kernels at the trainer evaluations' shapes",
                                phase_zoo_kernels, dev, card, paths)
        zoo = run_phase("26-34, 41-44, 49-51 training", phase_zoo_train, dev, paths, grads)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for pool in WRITERS + pools:
            pool.shutdown(cancel_futures=True)
        shutil.rmtree(SET_DIR, ignore_errors=True)
    overfit = learned["LightStereo"]
    overfits = {k: v for k, v in learned.items() if k != "LightStereo"}

    entries = [
        dict(name="corr_volume", route="cuda", source="openstereo_tpu_torch/csrc/cost_volume.cu",
             replaces="openstereo_tpu/ops/pallas/corr_volume.py:34",
             launches=launches["corr_volume"], max_abs_err=k1_err["main"][1],
             max_abs_err_f32=k1_err["main"][0], not_bit_equal_share=k1_err["main"][2],
             paths=path_entries(models, "corr_volume",
                                {name: dict(zip(VOLUME_ERR_KEYS, k1_err[name]))
                                 for name in ("CoEx", "FADNet")}),
             launches_trainer_eval=trainer_eval_launches(trained, zoo, "corr_volume"),
             eval_batch=dict(shape=list(K1_EVAL_SHAPE), max_abs_err=k1_eval[1],
                             max_abs_err_f32=k1_eval[0], not_bit_equal_share=k1_eval[2]),
             eval_batch2=volume_checks(zoo_kernels["corr_volume"]),
             eval_batch10=zoo_kernels["k1_eval10"],
             flip_share=VOLUME_FLIP_SHARE, library_ms=None, ptxas=ptxas["cost_volume"], **k1),
        dict(name="fused_mbconv", route="cuda", source="openstereo_tpu_torch/csrc/fused_mbconv.cu",
             replaces="openstereo_tpu/ops/pallas/fused_mbconv.py:53",
             launches=launches["fused_mbconv"], max_abs_err=k2_err[1],
             max_abs_err_f32=k2_err[0], library_ms=None,
             paths=path_entries(models, "fused_mbconv", {
                 name: {"max_abs_err_f32": max(k2_err[3][k][0] for k in want["fused_mbconv"]),
                        "max_abs_err": max(k2_err[3][k][1] for k in want["fused_mbconv"])}
                 for name, _, want, _, _ in model_paths() + [igev_path()] + igev_family_paths()
                 if "fused_mbconv" in want}),
             launches_trainer_eval=trainer_eval_launches(trained, zoo, "fused_mbconv"),
             eval_batch=dict(max_abs_err=k2_eval[1], max_abs_err_f32=k2_eval[0],
                             splits=[dict(shape=list(k), splits=v)
                                     for k, v in k2_eval_splits.items()]),
             trainer_eval=zoo_kernels["trainer_eval"]["fused_mbconv"],
             eval_batch2=dict(max_abs_err=zoo_kernels["fused_mbconv"][1],
                              max_abs_err_f32=zoo_kernels["fused_mbconv"][0],
                              splits=[dict(shape=list(k), splits=v)
                                      for k, v in zoo_kernels["fused_mbconv"][2].items()]),
             igev_eval=dict(launches=igev_eval["launches"]["fused_mbconv"],
                            batches=igev_eval["batches"], batch=igev_eval["batch"],
                            max_abs_err=igev_eval["k2_max_abs_err"],
                            max_abs_err_f32=igev_eval["k2_max_abs_err_f32"],
                            splits=igev_eval["k2_splits"], **igev_eval["k2"]),
             yardstick="eager cuDNN pw->dw->pw chain, folded BN", ptxas=ptxas["fused_mbconv"],
             flip_share=K2_FLIP_SHARE,
             controls=[dict(shape=list(shp), residual=res, control=ctl, beyond=c[0],
                            over_allowance=c[1]) for (shp, res, ctl), c in k2_err[2].items()],
             **k2),
        dict(name="rel_attention", route="cuda", source="openstereo_tpu_torch/csrc/rel_attention.cu",
             replaces="openstereo_tpu/ops/pallas/rel_attention.py:49",
             launches=k4_launches, max_abs_err=k4_err[1], max_abs_err_f32=k4_err[0],
             library_ms=None,
             yardstick="the port's eager einsum chain (gathered [W,W,E] tables, einsums, "
                       "softmax, p.v); a chain, not one call",
             ptxas=ptxas["rel_attention"], flip_share=K4_FLIP_SHARE,
             controls=[dict(shape=list(shp), control=ctl, beyond=c[0], over_allowance=c[1])
                       for shp, cs in k4_err[2].items() for ctl, c in cs.items()],
             **k4),
        k4_train_entry(k4_train, sttr_trained),
        dict(name="gwc_volume", route="cuda", source="openstereo_tpu_torch/csrc/cost_volume.cu",
             replaces="openstereo_tpu/ops/pallas/corr_volume.py:103",
             launches=k3_launches, max_abs_err=k3_err["main path"][1],
             max_abs_err_f32=k3_err["main path"][0], not_bit_equal_share=k3_err["main path"][2],
             flip_share=VOLUME_FLIP_SHARE, library_ms=None,
             paths=path_entries(models, "gwc_volume", {
                 "MSNet3D": dict(zip(VOLUME_ERR_KEYS, k3_err["main path"])),
                 "CFNet": dict(zip(VOLUME_ERR_KEYS, np.max([e for t, e in k3_err.items()
                                                            if t.startswith("CFNet")], axis=0)
                                   .tolist())),
                 **{name: dict(zip(VOLUME_ERR_KEYS, k3_err["IGEV"]))
                    for name in ("IGEV", "IGEV-RT", "StereoBase", "MonSter")},
                 "IGEV++": dict(zip(VOLUME_ERR_KEYS, k3_err["IGEV++"])),
                 **{name: dict(zip(VOLUME_ERR_KEYS, k3_err[f"{name} cosine"]))
                    for name, *_ in foundationstereo_paths()}}),
             igev_eval=dict(launches=igev_eval["launches"]["gwc_volume"],
                            batches=igev_eval["batches"], batch=igev_eval["batch"],
                            **dict(zip(VOLUME_ERR_KEYS, k3_err["IGEV evaluation"])),
                            **igev_eval["k3"]),
             launches_trainer_eval=trainer_eval_launches(trained, zoo, "gwc_volume"),
             eval_batch=volume_checks(zoo_kernels["gwc_volume"]),
             trainer_eval=zoo_kernels["trainer_eval"]["gwc_volume"],
             ptxas=ptxas["cost_volume"], **k3),
    ]
    print(f"[slice] fps eager {bench['eager']['fps']:.2f}, kernels {bench['kernels']['fps']:.2f}; "
          f"disparity f32 max-abs {max32:.3g}, bf16 mean-abs {mean16:.3g}; "
          f"total {time.perf_counter() - t0:.1f} s")
    raw_err, smax32, sshare32, smean16, sshare16 = sttr_agree
    print(f"[sttr] fps eager {sttr_bench['eager']['fps']:.3f}, kernels "
          f"{sttr_bench['kernels']['fps']:.3f}; f32 raw {raw_err:.3g}·max|raw|, disparity "
          f"max-abs {smax32:.4g} px ({sshare32:.6f} within 5e-3); bf16 mean-abs {smean16:.4g} px "
          f"({sshare16:.5f} within 3 px); device busy "
          f"{sttr_prof['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels), "
          f"{sttr_prof['eager']['device_busy_ms_per_frame']:.3f} (eager)")
    print(f"[gwcnet] fps eager {gwc_bench['eager']['fps']:.3f}, kernels "
          f"{gwc_bench['kernels']['fps']:.3f}; f32 max-abs {gwc_agree[0]:.3g} px, bf16 mean-abs "
          f"{gwc_agree[1]:.3g} px; device busy "
          f"{gwc_prof['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels), "
          f"{gwc_prof['eager']['device_busy_ms_per_frame']:.3f} (eager); PSMNet fps "
          f"{psm_bench['fps']:.3f}; total {time.perf_counter() - t0:.1f} s")
    for name, rec in models.items():
        b, p = rec["bench"], rec["profile"]
        print(f"[{name.lower()}] fps eager {b['eager']['fps']:.3f}, kernels "
              f"{b['kernels']['fps']:.3f} (group spread {b['eager']['group_spread']:.1%}, "
              f"{b['kernels']['group_spread']:.1%}; host issue {b['eager']['host_issue_ms']:.3f}, "
              f"{b['kernels']['host_issue_ms']:.3f} ms/frame); f32 max-abs {rec['max_abs_f32']:.3g} px "
              f"({rec['share_within_5e-3_f32']:.6f} within 5e-3), bf16 mean-abs "
              f"{rec['mean_abs_bf16']:.3g} px; device busy "
              f"{p['kernels']['device_busy_ms_per_frame']:.3f} ms/frame (kernels, idle "
              f"{p['kernels']['idle_share']:.4f}); peak {rec['peak_bytes'] / 2**30:.3f} GiB")
    print(f"[igev-eval] eval CLI, KITTI-format 384x1248 b{igev_eval['batch']} bf16: metrics with "
          f"kernels {igev_eval['metrics_kernels']}, eager {igev_eval['metrics_eager']}; measure "
          f"CLI: {models['IGEV']['measure']}; IGEV++: {models['IGEV++']['measure']}; "
          f"FoundationStereo: {models['FoundationStereo']['measure']}")
    print(f"[train] LightStereo-S 320x736 b24 bf16: {trained['ms_per_step']:.2f} ms/step (median "
          f"of steps 2-4), {trained['samples_per_s']:.1f} samples/s, peak "
          f"{trained['peak_bytes'] / 2**30:.3f} GiB; losses {trained['losses']}; evaluation EPE "
          f"{trained['eval_kernels']['epe']:.4f} px with kernels, {trained['eval_eager']['epe']:.4f} "
          f"eager; overfit final train EPE {overfit['final_epe']:.3f} px; total "
          f"{time.perf_counter() - t0:.1f} s")
    print(sttr_train_summary(sttr_trained, sttr_overfit, t0))
    print(zoo_train_summary(zoo, overfits))
    print("[phase-time] " + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
