#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`mscnn_torch`) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the root of the repository

Phases (any failure exits non-zero, before the result line):
  1. build   -- compile every CUDA kernel of the deploy paths from
                mscnn_torch/csrc/ (one nvcc per source, in parallel);
  2. nms     -- the NMS kernel (a sorted-order scan) against its plain
                version at the deploy path's two shapes and, in each IoU
                mode, at N = 1, N = 3072, with every score equal and with
                nothing valid: exactly equal;
  3. conv1   -- first the bias rounding of `C.conv2d` and `C.dense` in bf16
                with nonzero biases at a trunk conv's and fc6's shapes: bit
                for bit bf16(bf16(op without bias) + bf16(b)), as the JAX
                package rounds; then the fused conv1 kernel (K2) against
                its plain version at [4, 768, 2560, 3] (with zero and with
                nonzero biases), at odd sizes, below one tile and where the
                tiles wrap the grid, and with float32 w1 on the path's
                image: atol 0.02 * max|ref|, at most 2 bf16 ulps of
                max|ref| and at least 0.99 of the outputs bit-equal
                (conv1_1 from float32 w1 on the path's image, the control,
                must fail those gates); and bit for bit on an input whose
                sums are exact and whose w1 lies halfway between bf16
                values (conv1_1 must use the bf16-rounded w1);
  3b. conv1_v5 -- K3, the conv1 kernel with a selectable MMA schedule (K2's
                schedule with the probe's rounding points), in each mode
                (serial, mc, flat, bf16) and each compiled tile against its
                plain version at the probe's [1, 768, 2560, 3], at [1, 19,
                37, 3] and at [4, 768, 2560, 3], with the probe's zero
                biases and with nonzero ones: K2's gate (atol, 2 ulps,
                share 0.99); with zero biases serial / mc / flat against
                K2's kernel on the same input by the same gate; bf16
                measurably different from serial;
  4. int8    -- the int8 kernel (K4: wgmma + TMA) against its exact plain
                version at the TPU probe's three matmul shapes and at every
                int8 conv / dense shape of the int8 deploy path, raw int32,
                then in the path's epilogue (bf16, ReLU) with the int8
                copies each layer writes for the layers it feeds (pooled
                where a max pool sits between), and at ragged tile and
                image edges: every output equal;
  5. deploy  -- the flagship kitti_car/mscnn-8s-768-trainval deploy graph
                (bf16, fused conv1, batch 4 of seeded random uint8
                768x2560 images, seeded random weights) through the
                end-to-end forward, to KITTI label text; every kernel's
                launch count is read from that run alone, and each kernel
                is held against its plain version on the tensors that run
                gave it; a tiny float32 config is run on the card and on
                the CPU (plain kernels) and must agree;
  6. deploy int8 -- the same graph in its int8 deploy configuration
                (`mscnn detect --bf16 --int8 --int8-heads`: conv1 unfused,
                int8 trunk with conv1, int8 roi_c1 + fc6), calibrated as
                bench.py and the CLI do, through the end-to-end forward to
                KITTI text: 17 int8 launches and 2 NMS launches a step,
                each int8 launch (its output and its int8 copies) equal to
                its plain version on that run's own tensors, quantize_act
                twice a step (the image, the ROI gathers; once on the int8
                trunk alone), and no host sync in the int8 layers; a tiny
                int8 config on the card and on the CPU must give bit-equal
                trunk features;
  7. timing  -- CUDA-event medians of each kernel and its plain version at
                the paths' shapes, each int8 layer beside its bound, cuDNN's
                bf16 conv and `torch._int_mm` on its im2col matrix (both
                yardsticks only), `torch._int_mm` beside K4 at the probe
                shapes, the int8 trunk split (kernels / remaining quantize /
                pools), per-stage breakdowns and deploy img/s of the bf16
                control, the int8 trunk and the int8 trunk + heads;
  8. conv1 probes -- K3 in each mode and tile beside K2 (redesigned:
                timed before and after K3 in the same call), the plain block
                and cuDNN's unfused conv1_1 / conv1_2 / pool1 at
                [1, 768, 2560, 3] and [4, 768, 2560, 3]; then K3's own path,
                `mscnn_torch.examples.profile_conv1_v5.main()`, with every
                launch count read from that run alone, and its two sibling
                probes (profile_conv1, profile_conv1_pallas); then K4's
                probe, `mscnn_torch.examples.profile_int8_mxu.main()`, its
                launch count read from that run alone and every product
                bit-exact;
  9. trace   -- one `torch.profiler` window (utils/profiling.py::trace)
                over two steps of the bf16 deploy graph: the device-busy
                share of the window and the ten kernels with the most
                device time, or "not measured" where the trace holds no
                device time;
 10. conv1 backward -- K2 as an autograd function at [2, 64, 96, 3] and
                [4, 768, 1024, 3] with nonzero biases: its forward by K2's
                gate, its gradients for x, w1, b1, w2, b2 within 1e-6 of
                max|ref| of conv1_pool_plain's under autograd (the same
                ops), and the backward's time beside its bound;
 11. tiny train step -- one float32 stage-2 step of the tiny config on
                the card and on the CPU with the same draws: the same
                sampled rois, the loss within 1e-5, every update within
                1e-2 of max|step| (rel L2 2e-3); then a step with the
                fused conv1 block and conv1 trainable (K2 forward and
                backward inside the step) and K2 on the updated weights
                against its plain version;
 12. train   -- the flagship's stage-2 training step (768x1024 crops,
                batch 4, bf16, plain conv1, bench.py's solver, lr / decay
                multipliers, labels rasterised on the card from uint8
                images): the path's launches from its first step alone (1
                NMS), 2 warm-up steps, 5 synchronised steps (median ms,
                img/s, peak GiB), a CUDA-event split of a step, K1 at the
                training shape (on the step's candidates and on random
                ones), one step under sync debug mode "error", a profiler
                window over two steps, frozen layers bit-unchanged and
                every trainable leaf moved;
 13. train entry -- the training entry point at full width: 8 seeded
                375x1242 PPM images with 1-5 boxes and their window file,
                the flagship's trainval_1st / trainval_2nd and solver_1st /
                solver_2nd written from zoo.kitti_car_8s_768()
                (config/zoo_export.py) and imported back to it, then
                `mscnn_torch.cli train2 --bf16 --uint8-input --conv1 auto`
                through the worker loader, the CLI's default (a worker
                a core, no more than its 12 slots; 4 + 4 iterations,
                batch 4 of 768x1024 crops of images resized to
                768x2560, stage 2 snapshotting every 2) in
                deterministic mode (`train2_entry_point`, which phase 15
                shares): K2 8 launches and K1 4 (this run's counts alone),
                each launch held against its plain version on the run's
                tensors; (a) stage 2 warm-starts from stage 1's final
                snapshot bit for bit, frozen layers bit-unchanged through
                both stages; (b) stage 2 resumed from its iter-2 snapshot
                (`--snapshot`, the run's batches 2-3 replayed) equals the
                uninterrupted run bit for bit (else within 1e-2 of each
                weight's movement, the training step's tolerance, and says
                which); (c) the state written as .caffemodel /
                .solverstate reads back bit for bit; then 10 timed loop
                iterations (iteration ms, input wait and its share, peak
                memory), (e) one iteration and the batch transfer under
                sync debug mode "error", snapshot ms in each format, the
                host pipeline's resize and batch ms, a profiler window over
                two loop iterations, and (f) no jax, mscnn_tpu or cv2 in
                sys.modules;
 14. cascade deploy -- kitti_car/cascade-mscnn-7s-576-2x (3 stages, max_out
                512) at 576x1920, batch 4 of seeded uint8 images, seeded
                random weights with nonzero biases, bf16 with the fused conv1
                block, through detect_batch(cascade=) to KITTI text (2 K1,
                1 K2 launches), then detect_cascade at batch 1; each launch
                held to its plain version on the run's
                tensors (nms_equal, conv1_compare); a CUDA-event stage split
                (trunk, heads, propose, stage 1-3 heads, ensemble re-score,
                postprocess), host-clock step ms and img/s, peak memory, and a
                profiler window over two steps whose named ranges show the
                sliding-max table built once a forward and no re-score head
                (ensemble_avg off); the same cascade in int8 (trunk PTQ with
                conv1 + calibrate_roi_head_scales(ccfg=), the JAX CLI's
                --int8 --int8-heads): 15 trunk + 6 stage-head K4 launches,
                each equal to its plain version; widerface/cascade-mscnn-12s-
                align at 1024x1024, batch 1 (ROIAlign, the ensemble: 4
                re-score heads over two steps, no table); a tiny float32
                cascade (ROIAlign and the ensemble on and off) through
                make_cascade_forward on the card and on the CPU must agree;
 15. cascade train -- `mscnn_torch.cli train2 --bf16 --uint8-input --conv1
                auto`: stage 1 on zoo_export's kitti_car_7s_576_2x
                trainval_1st, stage 2 on its cascade trainval (warm-started:
                every stage-1 layer of the cascade's shape bit for bit),
                4 + 4 iterations of batch 4 at 576x768 over 8 seeded PPM
                images, on phase 13's harness (`train2_entry_point`): the
                same launch counts and checks, with the resume required
                bit-equal and every stage loss present and finite; 8 timed
                iterations;
 16. deploy entry points -- `mscnn_torch.cli` in this process on the
                flagship at 768x2560, max_out 256 (zoo entry FLAGSHIP_256),
                seeded weights with nonzero biases in a port snapshot:
                (a) 8 seeded 375x1242 PNGs whose rows use all five filters
                (`png_bytes`), decoded by data/image_io.py bit for bit, and
                their KITTI labels; (b) `detect --bf16 --conv1 auto`: 2 K1 +
                1 K2 an image, each held to its plain version, the label
                files equal to detect_batch's on the decoded images; (c)
                `detect --int8 --int8-heads` on 2 images: 17 K4 an image (+ 15
                a calibration image), each equal to plain; (d) `compile
                --bf16 --batch 4` and `compile --bf16 --int8 --int8-heads
                --batch 4`, `detect --compiled`; each loaded artifact against
                the eager forward on the same batch (bit-equal, else within
                1e-4 of max|ref| with the count printed), its K1 / K2 / K4
                launches held to plain, one call under sync debug mode
                "error"; (e) artifact against eager step (CUDA events, median
                of 5), img/s, busy share, the op layer's host time a call,
                detect's decode / resize / device split; (f) `serve` of the
                batch-4 artifact: 8 client threads, 16 PNG POSTs, each answer
                equal to compiled.detect, fewer device calls than requests,
                p50 / p99 latency, img/s; (g) `eval` of (b)'s labels; (h)
                `time --deploy --bf16 --max-out 256 --batch-size 4`; (i) the
                KITTI cascade through `compile --batch 1` and `detect
                --compiled`, equal to detect_cascade; (j) no jax, mscnn_tpu or
                cv2 module loaded;
 17. JPEG and the input path -- (a) every fixture of tests/assets/jpeg/
                (one small JPEG a decoding mode, the Adam7 PNGs, eight
                375x1242 JPEGs) decoded by data/image_io.py to cv2's array
                bit for bit (the manifest's SHA-256 of cv2.imread's array),
                the header shape equal, the JPEG decode ms an image; (b)
                `detect --bf16 --conv1 auto` on the eight JPEGs at 768x2560
                (2 K1 + 1 K2 an image, each held to plain, the labels equal
                to detect_batch's) and `detect --int8 --int8-heads`
                calibrated on two of them (17 K4 an image + 15 a head
                calibration image, each equal to plain), the decode / resize
                / device split; (c) one JPEG POSTed to `serve` (phase 16's
                batch-4 artifact), the answer equal to compiled.detect; (d)
                a record shard of the JPEGs, written by `cli
                convert_imageset --window-file`, through `train2` on phase 13's
                harness (its checks (a), (b) off; 20 timed iterations):
                through the worker loader (the CLI's default, a worker a
                core; its timed iterations again at 2 workers, through
                make_loader), then `--no-native`: the eight batches equal
                (digests) and the first iteration's losses equal, each run's
                input wait and share beside phase 13's; (e) no jax,
                mscnn_tpu or cv2 module loaded;
 18. generic nets -- (a) examples/mnist's LeNet at its published widths
                (conv 20 / 50, ip 500 / 10, batch 64, the solver's inv
                policy), its HDF5Data swapped for ImageData over 1,280
                seeded 28x28 PGM digits, through `cli train` (200
                iterations, one snapshot: the loss must fall to half) and
                `cli test` of the snapshot (finite loss and accuracy); one
                generic step on the card equal to the same step on the CPU
                (rtol 1e-4 / atol 1e-5, TF32 off); the step's ms with the
                batch on the card; (b) VGG16's deploy net (the Model Zoo's
                VGG_ILSVRC_16_layers_deploy layer list, gaussian weights)
                through classify.Classifier at 224x224 with 10 oversampled
                crops (input scale 0.017, so that the random logits stay
                O(1)): argmax equal to a CPU run's, probabilities within
                rtol 1e-3 / atol 1e-6, the 10-crop forward timed; (c) `cli
                time --layers --model` on it, the per-layer table printed;
                (d) none of K1-K4 launched (no TPU kernel lies on this
                path), no jax, mscnn_tpu, cv2 or h5py module loaded;
 19. Caffe databases -- (a) 10,000 seeded 28x28 PGM digits (MNIST's
                test-set count at its size), `cli convert_imageset
                --listfile` to an LMDB and to a LevelDB (records/s written,
                bytes on disk, records/s each reader reads and decodes), the
                two databases' records equal; (b) the LMDB, LevelDB and
                ImageData sources give bit-equal batches from the unshuffled
                list and one seed (crop, mirror, mean and scale on); (c)
                `cli compute_mean` on the list: its BGR triple and per-pixel
                BlobProto equal the numpy mean of the digits; (d) LeNet
                (examples/mnist/lenet.prototxt at its published widths) with
                its HDF5Data layers as `Data` layers, TRAIN on the LMDB
                (backend LMDB), TEST on the LevelDB, scale 1/256, through
                `cli train` (200 iterations: the loss must fall to half) and
                `cli test`; the step ms, host batch ms and `cli` iteration
                ms beside phase 18's ImageData figures; (e) a solver with
                `snapshot_format: HDF5` fails with the ImportError that names
                h5py where h5py is not installed (and writes the .h5 pair
                where it is), and in no other way; (f) none of K1-K4
                launched, no jax, mscnn_tpu or cv2 module loaded;
 20. tools  -- (a) data/jpeg_encode.py on the committed sources of
                tests/assets/jpeg_encode/ (colour and gray, 1x1-37x29, 8
                qualities) and on the eight 375x1242 scenes (decoded by the
                port) at q90 and q95: the SHA-256 of cv2's bytes and of
                cv2's decode (its manifest), encode and decode ms an image;
                (b), (c), (e) every case of tests/assets/tools_ref/
                make_fixtures.py through `mscnn_torch.cli`: `resize_images`
                with and without the crop, `convert_imageset --encode .jpg`
                of the scenes' window file to records, an LMDB and a
                LevelDB (read back through the port's readers: each record
                the scene's cv2 JPEG), `summary` on the card, `draw`,
                `upgrade_net_proto` / `upgrade_solver_proto`, `vbb2bbgt`:
                printed lines and file digests equal to the JAX CLI's (its
                manifest); `plot_log` writes a PNG or raises the
                ImportError naming matplotlib; (d) extract_features' forward
                on the flagship (deploy, 768x2560, float32) over the eight
                scenes with conv4_3, conv5_3 and the eight LFCN blobs:
                decode / resize / forward ms an image and the peak memory;
                the tiny config's blobs on the card equal the CPU's within
                rtol 1e-5 / atol 1e-5 * max|ref|; `cli extract_features`
                raises the ImportError naming h5py before it reads an image
                (with h5py: its file equals the forward); (f) none of K1-K4
                launched, no jax, mscnn_tpu or cv2 module loaded, the phase
                within 60 s;
 21. data parallel -- (a) the flagship stage-2 step (768x1024, batch 4,
                bf16, K2 + K1, nonzero biases) through
                `make_train_step(mesh=)` over NCCL at world size 1, 2 steps
                bit-equal to the step without a mesh under sync debug mode
                "error" (a K2 and a K1 launch a step, each held to its
                plain version); the step's ms with and without the mesh, in
                turns; the all-reduce's MB (every trainable float32
                gradient) and ms; (b) two ranks (`chip_smoke.py --dp-rank
                R`) sharing cuda:0 over gloo (NCCL refuses two ranks on one
                card), batch 2 each, 2 steps: the ranks' params bit-equal,
                and within 1e-2 of each leaf's move of one process that
                applies the mean of the two micro-batches' gradients; K1
                and K2 twice in each rank; (c) `make_forward(mesh=[cuda:0])`
                bit-equal to `make_forward` on the flagship deploy graph in
                bf16 and int8 + heads (K4), `detect_batch` over the mesh
                equal to `detect_batch`, `cli detect --devices 2` on one
                card exits with "mesh shape (2,) needs 2 devices, have 1",
                `cli detect --devices 1` writes `detect`'s label files; (d)
                no jax, mscnn_tpu or cv2 module in this process or either
                rank;
 22. data x space -- (a) phase 21's flagship step through
                `parallel/spmd.py::make_train_step_spmd` on a (1, 1)
                ("data", "space") mesh over NCCL at world size 1, 2 steps
                bit-equal to the step without a mesh under sync debug mode
                "error" (a K2 and a K1 launch a step, held to their plain
                versions); (b) two ranks (`chip_smoke.py --spmd-rank R`)
                of a (1, 2) mesh sharing cuda:0 over gloo, each the four
                images' 384-row bands (K2 on the band and its halo rows),
                2 steps with the global batch's draws: the ranks' params
                and metrics bit-identical, K1 and K2 held to their plain
                versions in each rank, the loss and metrics within 1e-2
                and each param leaf within 3e-2 of its move of the
                one-process step on the whole batch (the trunk's bf16
                weight gradients are rounded a band at a time), each
                rank's peak memory beside the one-process step's, the
                halo, gather and all-reduce ms (CUDA-event marks); (e)
                the flagship deploy forward (768x2560, batch 4, bf16)
                with `--conv1 s2d` against the plain conv1: pool1 by
                `conv1_compare`, conv4_3 within 2e-2 of max|ref|, ms of
                each; (c) no jax, mscnn_tpu or cv2 module in this process
                or either rank;
 23. examples -- every driver of mscnn_torch/examples/ that the JAX
                package's examples/ has (the flagship stage splits in bf16,
                once a conv1 route read from MSCNN_CONV1, and int8, the
                batch and ROI-chunk sweeps, the ROI stage, its batch and
                its gather variants, the training step and its parts, the
                cascade's ROI chunks, the widerface stages and budget)
                through `main([...])` at full width with --iters 1,
                `synthetic_e2e` at 300 iterations and 8 scenes, and
                `train_mscnn.sh` through bash on a tiny model directory
                (`--device cuda --bf16 --conv1 auto --no-native`, each
                `cli train` a child process): each run's launches read from that run
                alone, every K1, K2 and K4 launch held at once to its plain
                version on its own tensors, the drivers' own checks (the
                pre-top-k propose, the merged heads, the ROI variants, the
                per-image gathers and the chunked heads equal to
                production's; finite APs; stage 2 warm-started from stage
                1's last snapshot), under 240 s. No jax or mscnn_tpu module
                is loaded after any phase.

The lines before the last give the card's name and power limit
(nvidia-smi) and one JSON object listing every kernel, each with its
launches on its path, time, plain time, bound (the larger of the bytes
it must move over 3.35 TB/s and its operations over the peak of their
type) and library-call time (null where no one PyTorch call computes the
same function); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, the script exits non-zero and prints no result.
"""

import argparse
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 4
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
MEAN = (104.0, 117.0, 123.0)
# examples/profile_int8_mxu.py:97-99 (name, M, K, F)
K4_PROBES = (("im2col_conv2_1", 491520, 576, 128), ("tapdot_c64", 491520, 64, 128),
             ("big_control", 8192, 512, 512))
INT8_LAYERS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
               "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
               "conv5_3", "conv6_1", "loss1_conv1", "roi_c1", "fc6")
POOL_INPUTS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3", "conv6_1")
# the int8 copies each layer of the path writes for the int8 layers it feeds:
# one per consumer, True where a 2x2 max pool sits between (models/mscnn.py::
# int8_feeds; roi_c1 writes fc6's input)
COPIES = {"conv1_1": (False,), "conv1_2": (True,), "conv2_1": (False,),
          "conv2_2": (True,), "conv3_1": (False,), "conv3_2": (False,),
          "conv3_3": (True,), "conv4_1": (False,), "conv4_2": (False,),
          "conv4_3": (True, False), "conv5_1": (False,), "conv5_2": (False,),
          "conv5_3": (True,), "roi_c1": (False,)}
# ragged tile and image edges: (x [B, H, W, C], F, pad, copies)
K4_EDGES = (((1, 19, 37, 64), 64, 1, (True, False)), ((2, 17, 9, 128), 136, 1, (True,)),
            ((3, 7, 7, 1024), 512, 0, (False,)), ((1, 23, 41, 3), 64, 1, (True, False)))


# bound_ms: the larger of the bytes a call must move over the H100's memory
# rate and its operations over the peak of their type (NVIDIA's data sheet,
# SXM part at 700 W: bf16 dense tensor cores, int8 tensor cores, f32 off the
# tensor cores)
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
CONV1_FLOP_PER_PIXEL = 2 * 27 * 64 + 2 * 576 * 64   # conv1_1 + conv1_2: 77,184


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by) of a call moving `nbytes` and doing `ops`."""
    ms_b, ms_o = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (ms_b, "bytes") if ms_b >= ms_o else (ms_o, "operations")


def conv1_block_bound(x):
    """Bound of the fused conv1 block (K2, K3) on x [B, H, W, 3] bf16: the
    input and the pooled bf16 output against 77,184 FLOP a pixel."""
    B, H, W, _ = x.shape
    moved = B * H * W * 3 * 2 + B * ((H + 1) // 2) * ((W + 1) // 2) * 64 * 2
    return bound(moved, CONV1_FLOP_PER_PIXEL * B * H * W, PEAK["bf16"])


def jax_loaded():
    """Whether jax or any module of the JAX package (`mscnn_tpu`, jax-free
    modules included) is imported."""
    return any(m in ("jax", "mscnn_tpu") or m.startswith(("jax.", "mscnn_tpu."))
               for m in sys.modules)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# K2's gates against its plain version on random inputs: atol 0.02 * max|ref|,
# and, since that passes a rounding fault (conv1_1 from float32 weights moves
# ~40% of the outputs by one bf16 ulp), at least CONV1_MIN_SHARE of the
# outputs bit-equal and no output further than CONV1_MAX_ULPS bf16 ulps of
# max|ref| away
CONV1_MIN_SHARE = 0.99
CONV1_MAX_ULPS = 2


def conv1_compare(got, want):
    """(max_abs_err, atol, bit-equal share, ulp limit, passed) of K2's output
    against its plain version's (both float)."""
    if got.shape != want.shape:
        return math.inf, 0.0, 0.0, 0.0, False
    ref = want.abs().max().item()
    err = (got - want).abs().max().item()
    eq = (got == want).float().mean().item()
    tol = 0.02 * ref
    ulps = CONV1_MAX_ULPS * 2.0 ** (math.floor(math.log2(ref)) - 7) if ref > 0 else 0.0
    return err, tol, eq, ulps, err <= tol and err <= ulps and eq >= CONV1_MIN_SHARE


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=5, warmup=2):
    """Median milliseconds of fn() over `iters` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def program_enqueue_ms(c, batch, iters=20):
    """Host enqueue ms (median of `iters` after one warm-up; no synchronise
    inside a call) of a loaded artifact's program three ways: through
    `program.module()` as `CompiledDeploy` calls it (its input checks on),
    with those checks off, and its graph module on inputs flattened once
    beforehand (the params' leaves, the batch, the lifted constants). The
    three must give the same tensors."""
    import torch
    from torch.export.graph_signature import InputKind
    from torch.utils import _pytree

    fn, gm = c._fn, c.program.graph_module
    leaves = iter(_pytree.tree_leaves((c.params,) + tuple(batch)))
    flat = [next(leaves) if s.kind == InputKind.USER_INPUT
            else c.program.constants[s.target]
            for s in c.program.graph_signature.input_specs]

    def unchecked():
        fn.validate_inputs = False
        try:
            return fn(c.params, *batch)
        finally:
            fn.validate_inputs = True

    ways = {"module": lambda: fn(c.params, *batch), "unchecked": unchecked,
            "flat": lambda: gm(*flat)}
    times = {k: [] for k in ways}
    with torch.inference_mode():
        ref = _pytree.tree_leaves(ways["module"]())
        for k in ("unchecked", "flat"):
            got = _pytree.tree_leaves(ways[k]())
            if len(got) != len(ref) or not all(torch.equal(a, b)
                                               for a, b in zip(got, ref)):
                fail(f"program enqueue: the {k} call differs from the module's")
        for i in range(iters + 1):
            for k, f in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                if i:
                    times[k].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def graph_ms(fn, calls=10, iters=5):
    """Device milliseconds of one fn() call: `calls` calls captured in one
    CUDA graph, replayed `iters` times (median, CUDA events), divided by
    `calls`. A short kernel launched from Python takes longer to enqueue
    than to run, so `cuda_ms` of one call reads the host's time; the
    replay leaves only the device's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=iters) / calls


def nms_equal(got, want):
    import torch
    return all(torch.equal(g, w) for g, w in zip(got, want))


def nms_err(got, want):
    return max((g.float() - w.float()).abs().max().item() if g.numel() else 0.0
               for g, w in zip(got, want))


def random_candidates(gen, p, n, img=2560.0):
    import torch
    xy = torch.rand((p, n, 2), generator=gen) * img * 0.8
    wh = 5 + torch.rand((p, n, 2), generator=gen) * img * 0.2
    scores = torch.randn((p, n), generator=gen)
    valid = torch.rand((p, n), generator=gen) > 0.2
    return torch.cat([xy, wh], -1), scores, valid


def int8_shapes(batch, H, W, rois):
    """(name, x [B, H, W, C], w [F, kh, kw, C], pad) of every int8 launch of
    the flagship int8 deploy path, in launch order; fc6 is the 1x1-over-1x1
    (dense) case."""
    from mscnn_torch.models import mscnn as M
    rows, c, h, w = [], 3, H, W
    for name, f in M.VGG_BLOCKS:
        rows.append((name, (batch, h, w, c), (f, 3, 3, c), 1))
        c = f
        if name in M.POOL_AFTER:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
    rows.append(("conv6_1", (batch, h, w, 512), (512, 3, 3, 512), 1))
    rows.append(("loss1_conv1", (batch, H // 8, W // 8, 512), (512, 3, 3, 512), 1))
    rows.append(("roi_c1", (rois, 7, 7, 1024), (512, 3, 3, 1024), 0))
    rows.append(("fc6", (rois, 1, 1, 5 * 5 * 512), (4096, 1, 1, 5 * 5 * 512), 0))
    assert tuple(r[0] for r in rows) == INT8_LAYERS
    return rows


def stage_breakdown(M, I, params, cfg, imgs, mean, ratios, orig_wh):
    """Median CUDA-event ms of each deploy stage over 3 passes after a
    warm-up."""
    import torch
    stage_ms = {k: [] for k in ("input", "trunk", "heads", "propose",
                                "roi_head", "postprocess")}
    B = imgs.shape[0]
    R = cfg.proposal.max_out
    with torch.inference_mode():
        for it in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            x = imgs.float() - mean
            ev[1].record()
            feats = M.trunk(params, x, cfg)
            ev[2].record()
            outs = M.heads(params, feats, cfg)
            ev[3].record()
            prop = M.propose(outs, cfg)
            ev[4].record()
            bidx, rb, rs, rv = M.flatten_proposals(prop)
            cls, bbox = M.roi_head(params, feats["conv4_3"], bidx, rb, rv, cfg)
            ev[5].record()
            per = {"rois": rb.reshape(B, R, 4), "roi_scores": rs.reshape(B, R),
                   "roi_valid": rv.reshape(B, R), "cls_pred": cls.reshape(B, R, -1),
                   "bbox_pred": bbox.reshape(B, R, -1)}
            I.postprocess_batch(per, ratios, orig_wh, cfg, I.DetectSpec())
            ev[6].record()
            ev[6].synchronize()
            if it:   # the first pass is a warm-up
                for j, k in enumerate(stage_ms):
                    stage_ms[k].append(ev[j].elapsed_time(ev[j + 1]))
            del feats, outs, prop
    return {k: statistics.median(v) for k, v in stage_ms.items()}


def deploy_step(fwd, params, imgs, ratios, orig_wh):
    """(median s/step over 5 synchronised steps after 2 warm-ups, peak GiB)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        fwd(params, imgs, ratios, orig_wh)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fwd(params, imgs, ratios, orig_wh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2 ** 30


def check_kitti(I, out, batch, names=None):
    """Write the batch's detections as KITTI label files; fail on a malformed
    line. Returns (line count, first line)."""
    with tempfile.TemporaryDirectory() as tmp:
        names = names or I.KITTI_CLASS_NAMES["kitti_car"]
        lines, first = 0, None
        for i in range(batch):
            det = {k: out[k][i] for k in ("boxes", "scores", "valid")}
            I.write_kitti_labels(I.detections_to_kitti(det, names), tmp, i)
            with open(os.path.join(tmp, f"{i:06d}.txt")) as f:
                rows = f.read().splitlines()
            if any(len(r.split()) != 16 or r.split()[0] not in names for r in rows):
                fail(f"malformed KITTI label line in {i:06d}.txt")
            lines += len(rows)
            first = first or (rows[0] if rows else None)
    return lines, first


def check_deploy_out(out, cfg, batch):
    import torch
    nc = cfg.num_classes
    if tuple(out["boxes"].shape) != (batch, nc - 1, 100, 4) or \
            tuple(out["rois"].shape) != (batch, cfg.proposal.max_out, 4):
        fail(f"deploy output shapes {tuple(out['boxes'].shape)}, "
             f"{tuple(out['rois'].shape)}")
    for k in ("boxes", "scores", "rois", "roi_scores"):
        if not torch.isfinite(out[k]).all():
            fail(f"deploy output {k} is not finite")


def calibrate_int8(Q, params, cfg, cal):
    """Trunk scales (conv1 included, percentile 99.9, bench.py:45-59), then
    the ROI-head scales on the int8 trunk (cli.py:530-543); returns the
    quantized params."""
    fcfg = dataclasses.replace(cfg, int8_trunk=False, int8_roi_head=False)
    scales = Q.calibrate_trunk_scales(params, fcfg, cal, include_conv1=True)
    params = Q.quantize_trunk(params, scales)
    hcfg = dataclasses.replace(cfg, int8_trunk=True, int8_roi_head=False)
    hscales = Q.calibrate_roi_head_scales(params, hcfg, cal)
    return Q.quantize_roi_heads(params, hscales), scales, hscales


def trace_window(PROF, run, label, what, note, annotations=None):
    """One `torch.profiler` window over two calls of run(), each annotated
    `label`: logs the window, the device-busy share, the ten kernels with
    the most device time and the time of K1 and K2 by name. Returns the
    busy share (None where the trace holds no device time). annotations:
    an optional dict that receives the count of each named range of the
    window (`utils/profiling.py::annotate`, `record_function`)."""
    import torch
    with tempfile.TemporaryDirectory() as tdir:
        with PROF.trace(tdir) as prof:
            for _ in range(2):
                with PROF.annotate(label):
                    run()
            torch.cuda.synchronize()
        with open(os.path.join(tdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    dev_total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages())
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == label]
    if annotations is not None:
        for e in events:
            if e.get("cat") == "user_annotation":
                annotations[e["name"]] = annotations.get(e["name"], 0) + 1
    if not (busy and steps and dev_total > 0):
        log("trace: device busy share not measured: the profiler window holds no "
            f"device time ({len(busy)} device events, key_averages device total "
            f"{dev_total}); {note}")
        return None
    lo = min(s_ for s_, _ in steps)
    hi = max(max(e_ for _, e_ in steps), max(e_ for _, e_ in busy))
    union, end = 0.0, lo
    for s_, e_ in sorted(busy):
        s_, e_ = max(s_, end), min(e_, hi)
        if e_ > s_:
            union, end = union + e_ - s_, e_
    busy_share = union / (hi - lo)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            n_, t_ = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n_ + 1, t_ + e["dur"])
    log(f"trace: {what}, window {(hi - lo) / 1e3:.3f} ms, device "
        f"busy {union / 1e3:.3f} ms = share {busy_share:.4f}, idle share "
        f"{1 - busy_share:.4f}; {len(busy)} device events")
    for n_, (cnt, t_) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"trace kernel {t_ / 1e3:9.3f} ms {cnt:5d}x  {n_[:110]}")
    for ours in ("nms_kernel", "conv1_block_kernel"):   # K1, K2 (K3 is not on the path)
        hits = [(cnt, t_) for n_, (cnt, t_) in by_name.items() if ours in n_]
        log(f"trace {ours}: " + (f"{sum(t_ for _, t_ in hits) / 1e3:.4f} ms in "
                                 f"{sum(c for c, _ in hits)} launches over two steps"
                                 if hits else "not in the trace"))
    return busy_share


KITTI_HW = (375, 1242)   # a KITTI image
TRAIN_IMAGES = 8


def write_ppm(path, bgr):
    """A binary PPM (P6) of an HxWx3 BGR uint8 image, as cv2.imwrite writes it."""
    h, w, _ = bgr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + bgr[:, :, ::-1].tobytes())


def write_kitti_like(root, n, seed):
    """n seeded KITTI-size PPM images, 1-5 flat car boxes each on a noisy
    background whose mean is near the net's mean values (as a photograph's
    is: far-off input statistics blow up the random-weight losses), and
    their window file (label 1, not ignored). Returns the window file's
    path."""
    import numpy as np
    from mscnn_torch.data import window_file as W

    rng = np.random.RandomState(seed)
    h, w = KITTI_HW
    images = []
    for i in range(n):
        img = rng.randint(30, 220, (h, w, 3)).astype(np.uint8)
        gts = []
        for _ in range(rng.randint(1, 6)):
            bw, bh = rng.randint(w // 20, w // 4), rng.randint(h // 9, h * 2 // 5)
            x1, y1 = rng.randint(0, w - bw), rng.randint(h // 4, h - bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
            gts.append([1, 0, x1, y1, x1 + bw - 1, y1 + bh - 1])
        path = os.path.join(root, f"{i:06d}.ppm")
        write_ppm(path, img)
        images.append(W.WindowImage(path, 3, h, w, np.asarray(gts, np.float32),
                                    np.zeros((0, 4), np.float32)))
    wf = os.path.join(root, "trainval.txt")
    W.write_window_file(wf, images)
    return wf


def flagship_training_specs(stage, root):
    """The flagship's stage-1 / stage-2 training specs: the zoo config in
    training geometry (768x1024 crops), the reference kitti_car trainval's
    augmentation shape (resize to the deploy 768x2560, multi-scale over the
    fields 60-672, mirror, min gt height 35), batch 4, bench.py's solver
    (SGD, step policy, momentum 0.9, weight decay 5e-4) at a tenth of its
    learning rate (5e-6: the weights are random, not VGG16's, and at 5e-5
    the losses grew 10x in two steps); 4 iterations, display every 2,
    stage 2 snapshots every 2."""
    from mscnn_torch.data.augment import AugmentSpec
    from mscnn_torch.data.pipeline import DatasetSpec
    from mscnn_torch.models import zoo
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train.solver import SolverSpec
    from mscnn_torch.train.train_step import TrainSpec

    cfg = zoo.kitti_car_8s_768()
    # stage 1 has no ProposalTarget: its roi fields are the importer's defaults
    tspec = TrainSpec(stage=2) if stage == 2 else \
        TrainSpec(stage=1, sample_mode="random", roi_bg_thr_hg=0.5)
    aug = AugmentSpec(template_hw=cfg.input_hw, resize_hw=(768, 2560), mirror=True,
                      do_multiple_scale=True, min_scale=60, max_scale=672,
                      min_gt_height=35.0)
    sspec = SolverSpec(type="sgd", base_lr=5e-6, lr_policy="step", gamma=0.1,
                       stepsize=10000, max_iter=4, momentum=0.9, weight_decay=5e-4)
    lspec = LP.LoopSpec(max_iter=4, display=2, snapshot=2 if stage == 2 else 0,
                        snapshot_prefix=os.path.join(root, f"s{stage}"))
    return cfg, tspec, aug, DatasetSpec(batch_size=BATCH), sspec, lspec


def tree_diff(a, b):
    """The leaves of b's {name: {leaf: tensor}} tree that a does not hold
    bit for bit (dtype, shape and values)."""
    import torch
    return [f"{n}.{k}" for n, p in b.items() for k, v in p.items()
            if a[n][k].dtype != v.dtype or a[n][k].shape != v.shape
            or not torch.equal(a[n][k].cpu(), v.cpu())]


def cli_args(cli, *argv):
    """The arguments `mscnn_torch.cli train` parses from argv."""
    p = argparse.ArgumentParser()
    cli._add_common(p)
    return p.parse_args(list(argv))


def batch_digest(batch):
    """One SHA-256 over a batch dict's arrays (host copies, sorted keys)."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        v = v.cpu().numpy() if torch.is_tensor(v) else v
        h.update(k.encode() + str(v.dtype).encode() + str(v.shape).encode() + v.tobytes())
    return h.hexdigest()


def one_thread_dataset(wf, aug, dspec):
    """The one-thread pipeline's dataset over a window file or a record shard."""
    from mscnn_torch.data import pipeline as P
    from mscnn_torch.data import records as R
    if R.is_record_shard(wf):
        return R.RecordShard(wf).dataset(aug, dspec)
    return P.dataset_from_window_file(wf, aug, dspec)


def train2_entry_point(tag, dev, counts, zero_counts, PROF, *, seed, train_hw,
                       write_nets, check_warm, loss_keys, exact_resume, timed_iters,
                       extra=None, write_data=None, argv_extra=(), timed_extra=(),
                       full=True):
    """`mscnn_torch.cli train2` from one model's stage-1 trainval to its
    stage-2 trainval at full width: the harness phases 13 and 15 share
    (module notes). write_nets(root, wf) writes and checks the texts and
    returns {stage: (net, solver, snapshot prefix)}; check_warm(build, s1,
    snap1, ref) checks stage 2's warm start from stage 1's final params s1
    (ref: stage 2's final state; build(*args): cli._build_training of
    stage 2 with those arguments) and returns its log line; loss_keys: the
    display metrics every stage-2 iteration reports, finite; exact_resume:
    the resumed run must equal the uninterrupted one bit for bit (else
    within the training step's tolerance); extra(root, wf, paths, ref, out)
    runs the model's own checks on ref. write_data(root) writes the images
    and returns the window file or record shard (default: write_kitti_like's
    PPMs); argv_extra: more CLI arguments for every run (e.g. --no-native);
    timed_extra: (label, make_loader keywords) of more loader set-ups to
    time as the timed iterations are timed; full=False leaves out (a), (b),
    extra and the profiler window. Returns the figures the kernels line and
    the log use, with each batch's digest and the display metrics of both
    stages (`shown`)."""
    import warnings

    import numpy as np
    import torch

    from mscnn_torch import cli
    from mscnn_torch.config import zoo_import as ZI
    from mscnn_torch.data import native_loader as NL
    from mscnn_torch.data import pipeline as P
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.ops import nms as nms_ops
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import nms_kernel as NK
    from mscnn_torch.train import loop as LP

    out = {}
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    wf = write_data(root) if write_data else write_kitti_like(root, TRAIN_IMAGES, seed)
    paths = write_nets(root, wf)

    # -- the run: train2, counts from this run alone, the kernels' inputs kept
    calls = {"nms": [], "conv1": []}
    nms_cuda, conv1_cuda = NK.nms_xywh_cuda, CK.conv1_pool_cuda

    def rec_nms(*a, **kw):
        o = nms_cuda(*a, **kw)
        calls["nms"].append((a, kw, o))
        return o

    def rec_conv1(*a):
        o = conv1_cuda(*a)
        calls["conv1"].append((a, o))
        return o

    batches = []
    get = P.Prefetcher.get

    def rec_get(self, *a, **kw):
        b = get(self, *a, **kw)
        batches.append(b)
        return b

    shown = []
    solve = LP.solve

    def rec_solve(*a, hooks=(), **kw):
        return solve(*a, hooks=list(hooks) + [lambda it, m: shown.append((it, dict(m)))],
                     **kw)

    argv = ["train2", "--solver1", paths[1][1], "--solver2", paths[2][1], "--bf16",
            "--uint8-input", "--conv1", "auto", "--seed", str(SEED), *argv_extra]
    # bitwise resume needs deterministic kernels (cuBLAS: its workspace config)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    NK.nms_xywh_cuda, CK.conv1_pool_cuda, P.Prefetcher.get = rec_nms, rec_conv1, rec_get
    LP.solve = rec_solve
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            zero_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = counts()
    finally:
        NK.nms_xywh_cuda, CK.conv1_pool_cuda, P.Prefetcher.get = nms_cuda, conv1_cuda, get
        LP.solve = solve
    out["batch_digests"] = [batch_digest(b) for b in batches]
    out["shown"] = shown
    nondet = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                     if "deterministic" in str(w.message)})
    if rc != 0:
        fail(f"{tag}: `mscnn_torch.cli train2` returned {rc}")
    log(f"{tag}: `python -m mscnn_torch.cli train2 ... --bf16 --uint8-input --conv1 "
        f"auto`: {run_s:.1f} s for 4 + 4 iterations at {BATCH}x{train_hw[0]}x"
        f"{train_hw[1]}, launches {launches}; deterministic mode, ops without a "
        f"deterministic kernel: {nondet or 'none'}")
    # (d) K2 every iteration of both stages (conv1 auto: the fused kernel at
    # bf16 on the card), K1 every stage-2 iteration (its propose)
    if launches["conv1_pool"] != 8 or launches["nms"] != 4 or \
            launches["int8_gemm"] or launches["conv1_v5"]:
        fail(f"{tag}: launches {launches}, expected 8 conv1_pool (every iteration) "
             f"and 4 nms (one a stage-2 iteration)")
    k2_share, k2_err = 1.0, 0.0
    for a, o in calls["conv1"]:
        err, tol, eq, ulps, ok = conv1_compare(o.float(), CK.conv1_pool_plain(*a).float())
        if tuple(a[0].shape) != (BATCH, *train_hw, 3) or not ok:
            fail(f"{tag}: K2 at {tuple(a[0].shape)} != plain (err {err:.4g}, atol "
                 f"{tol:.4g}, {ulps:.4g} for 2 ulps, bit-equal share {eq:.4f})")
        k2_share, k2_err = min(k2_share, eq), max(k2_err, err)
    for a, kw, o in calls["nms"]:
        if not nms_equal(o, nms_ops.nms_xywh_plain(*a, **kw)):
            fail(f"{tag}: K1 at {tuple(a[0].shape)} != plain")
    na = calls["nms"][0][0]
    log(f"{tag}: K2 on all 8 batches within K2's gate (bit-equal share >= "
        f"{k2_share:.4f}, max err {k2_err:.4g}); K1 equal to plain on all 4 launches "
        f"at P={na[0].shape[0]} N={na[0].shape[1]} "
        f"(kept {[int(o[2].sum()) for _, _, o in calls['nms']]})")
    out.update(launches=launches, k2_share=k2_share, k2_err=k2_err, run_s=run_s)
    del calls

    # (a) warm start
    snap1 = CKPT.latest_snapshot(paths[1][2])
    snap2 = CKPT.latest_snapshot(paths[2][2])
    if not (snap1 and snap1.endswith("_iter_4") and snap2 and snap2.endswith("_iter_4")):
        fail(f"{tag}: snapshots {snap1}, {snap2}")
    s1 = torch.load(os.path.join(snap1, CKPT.STATE_FILE), map_location="cpu",
                    weights_only=True)["params"]
    ref = torch.load(os.path.join(snap2, CKPT.STATE_FILE), map_location="cpu",
                     weights_only=True)
    common = ("--bf16", "--uint8-input", "--conv1", "auto", "--seed", str(SEED),
              *argv_extra)

    def build(*args):
        return cli._build_training(cli_args(cli, *common, *args), paths[2][1])

    if full:   # (a) the warm start, (b) the resume, the model's own checks
        log(f"{tag}: (a) " + check_warm(build, s1, snap1, ref))
        del s1

        # (b) resume: the iter-2 snapshot through the CLI's --snapshot path, then
        # stage 2's iterations 2 and 3 on the batches the run gave them
        st2, step2, _, lspec2, _, _ = build("--snapshot", f"{paths[2][2]}_iter_2")
        if int(st2["solver"]["it"]) != 2 or len(batches) != 8:
            fail(f"{tag}: resumed at {int(st2['solver']['it'])}, {len(batches)} batches")
        replay = iter(batches[6:8])
        seen = []
        resumed = LP.solve(step2, st2, lambda: next(replay),
                           dataclasses.replace(lspec2, snapshot=0, snapshot_prefix="",
                                               display=1),
                           seed=SEED, log=lambda m: None,
                           hooks=[lambda it, m: seen.append(dict(m))])
        torch.use_deterministic_algorithms(False)
        diff = tree_diff(resumed["params"], ref["params"]) + \
            tree_diff(resumed["solver"]["h1"], ref["solver"]["h1"])
        if int(resumed["solver"]["it"]) != 4 or (diff and exact_resume):
            fail(f"{tag}: (b) the resumed run differs from the uninterrupted one: "
                 f"{diff[:5]} ({len(diff)} leaves), iter {int(resumed['solver']['it'])}")
        if not diff:
            out["resume"] = "bit-equal"
        else:
            # the training step's tolerance (phase 11, tests/test_torch_train_step.py):
            # 1e-2 of each weight's movement over the two steps
            st_w = torch.load(os.path.join(f"{paths[2][2]}_iter_2", CKPT.STATE_FILE),
                              map_location="cpu", weights_only=True)
            worst = 0.0
            for n, p in ref["params"].items():
                for k, w in p.items():
                    g, w0 = resumed["params"][n][k].cpu(), st_w["params"][n][k]
                    mv = (w - w0).abs().max().item()
                    err = (g - w).abs().max().item()
                    if err > 1e-2 * mv + 4 * np.spacing(np.float32(w.abs().max().item())):
                        fail(f"{tag}: (b) the resumed {n}.{k} is {err:.4g} from the "
                             f"uninterrupted run's (movement {mv:.4g})")
                    worst = max(worst, err / mv if mv else 0.0)
            out["resume"] = f"within the step tolerance ({len(diff)} leaves not " \
                            f"bit-equal, worst {worst:.3g} of the movement)"
        if len(seen) != 2 or not all(set(loss_keys) <= set(m) and all(
                math.isfinite(v) for v in m.values()) for m in seen):
            fail(f"{tag}: (b) losses of iterations 2-3 {seen}")
        out["losses"] = {k: seen[0][k] for k in sorted(loss_keys)}
        log(f"{tag}: (b) resumed from {os.path.basename(paths[2][2])}_iter_2 "
            f"(`--snapshot`, stage 2's own batches 2-3 replayed: the data stream "
            f"restarts on resume, as in the reference) to iter 4: {out['resume']} "
            f"against the uninterrupted run; iteration 2's "
            + ", ".join(f"{k} {v:.4f}" for k, v in out["losses"].items()))
        del resumed, st2, replay
        if extra is not None:
            extra(root, wf, paths, ref, out)
    torch.use_deterministic_algorithms(False)
    del ref

    # the loop's cost: stage 2 resumed from its final snapshot for timed_iters
    # more iterations, display every 2 (a sync there), host clock between
    # displays
    state, step, make_source, lspec, _, _ = build("--snapshot", snap2)
    aug2, dspec2 = ZI.model_from_prototxt(paths[2][0])[2:4]
    host = one_thread_dataset(wf, dataclasses.replace(aug2, emit_uint8=True),
                              dspec2).next_batch()   # the transfer check
    lspec = dataclasses.replace(lspec, max_iter=4 + timed_iters, display=2, snapshot=0,
                                snapshot_prefix="")
    marks, waits, it_box = [], [], [4]
    SYNC_IT = 7   # display not due
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with make_source() as src:
        def source():
            it = it_box[0]
            # iteration SYNC_IT, its batch fetch included, under "error"
            torch.cuda.set_sync_debug_mode("error" if it == SYNC_IT else "default")
            t = time.perf_counter()
            b = src.get()
            waits.append((it, time.perf_counter() - t))
            it_box[0] += 1
            return b

        try:
            state = LP.solve(step, state, source, lspec, seed=SEED, log=lambda m: None,
                             hooks=[lambda it, m: marks.append((it, time.perf_counter(),
                                                                dict(m)))])
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            fail(f"{tag}: (e) a stage-2 iteration synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # the batch transfer alone, under the same mode: pinned copy on the
        # copy stream, the consumer's stream waits on its event
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            to_dev = P._ToDevice(dev)
            moved_batch = to_dev.take(to_dev.put(host))
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            fail(f"{tag}: (e) the batch transfer synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not all(torch.equal(moved_batch[k].cpu(), torch.from_numpy(v))
                   for k, v in host.items()):
            fail(f"{tag}: the batch transfer changed the batch")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        windows = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
        iter_ms = statistics.median(windows) * 1e3
        wait = [w for it, w in waits if marks[0][0] < it <= marks[-1][0]]
        wait_ms = statistics.median(wait) * 1e3
        share = sum(wait) / (marks[-1][1] - marks[0][1])
        if len(marks) != timed_iters // 2 or not all(
                set(loss_keys) <= set(m) and all(math.isfinite(v) for v in m.values())
                for _, _, m in marks):
            fail(f"{tag}: display marks {marks}")
        log(f"{tag}: (e) iteration {SYNC_IT} (display not due: batch fetch, step, loop "
            f"bookkeeping) under sync debug mode 'error': no host sync; the batch "
            f"transfer alone under it: no host sync, the batch equal")
        log(f"{tag}: stage 2 iterations 4-{3 + timed_iters}, display every 2: "
            f"iteration {iter_ms:.2f} ms (median of {len(windows)} two-iteration "
            f"windows: {', '.join(f'{w * 1e3:.2f}' for w in windows)}), input wait "
            f"{wait_ms:.2f} ms a step (median; inside batch_source()), {share:.4f} of "
            f"the iterations' time; peak {peak:.2f} GiB; losses "
            f"{', '.join(f'{m[2]['loss']:.4f}' for m in marks)}")

        # two loop iterations in a profiler window (one solve call each)
        def one_iteration():
            nonlocal state
            state = LP.solve(step, state, src.get, dataclasses.replace(
                lspec, max_iter=int(state["solver"]["it"]) + 1, display=0),
                seed=SEED, log=lambda m: None)

        busy = trace_window(PROF, one_iteration, f"{tag.replace(' ', '_')}_iteration",
                            f"two loop iterations of {tag}",
                            "the iteration ms above is a host-clock time") \
            if full else None
    out.update(iter_ms=iter_ms, wait_ms=wait_ms, wait_share=share, peak_gib=peak,
               busy=busy, timed={})
    for label, loader_kw in timed_extra:
        # the same timed iterations from the final snapshot through another
        # loader set-up (host clock between displays; the wait inside get())
        state, step, make_source, lspec, _, _ = build("--snapshot", snap2)
        lspec = dataclasses.replace(lspec, max_iter=4 + timed_iters, display=2,
                                    snapshot=0, snapshot_prefix="")
        marks, waits, it_box = [], [], [4]
        make_loader = NL.make_loader
        NL.make_loader = lambda *a, **kw: make_loader(*a, **{**kw, **loader_kw})
        try:
            src = make_source()
        finally:
            NL.make_loader = make_loader
        with src:
            def source():
                t = time.perf_counter()
                b = src.get()
                waits.append((it_box[0], time.perf_counter() - t))
                it_box[0] += 1
                return b

            state = LP.solve(step, state, source, lspec, seed=SEED, log=lambda m: None,
                             hooks=[lambda it, m: marks.append((it, time.perf_counter()))])
            torch.cuda.synchronize()
            stats = getattr(getattr(src, "dataset", None), "stats", None)
        windows = [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
        inside = [w for it, w in waits if marks[0][0] < it <= marks[-1][0]]
        out["timed"][label] = {
            "iter_ms": statistics.median(windows) * 1e3,
            "wait_ms": statistics.median(inside) * 1e3,
            "wait_share": sum(inside) / (marks[-1][1] - marks[0][1]),
            "stats": dict(stats) if isinstance(stats, dict) else None}
        t = out["timed"][label]
        log(f"{tag}: {label}: iteration {t['iter_ms']:.2f} ms (median of "
            f"{len(windows)} two-iteration windows: "
            f"{', '.join(f'{w * 1e3:.2f}' for w in windows)}), input wait "
            f"{t['wait_ms']:.2f} ms a step (median), {t['wait_share']:.4f} of the "
            f"iterations' time")
    del state, step, moved_batch, batches
    tmp.cleanup()
    torch.cuda.empty_cache()
    loaded = [m for m in sys.modules if m in ("jax", "mscnn_tpu", "cv2")
              or m.startswith(("jax.", "mscnn_tpu.", "cv2."))]
    if loaded:
        fail(f"{tag}: (f) {loaded[:5]} imported")
    log(f"{tag}: (f) neither jax, mscnn_tpu nor cv2 is in sys.modules")
    return out


def training_entry_point(dev, counts, zero_counts, PROF, tag="train entry", **harness):
    """Phase 13: `mscnn_torch.cli train2` on the flagship at full width
    (module notes). harness: more of train2_entry_point's arguments (phase
    17's runs over a JPEG shard). Returns the figures the kernels line and
    the log use."""
    import torch

    from mscnn_torch.config import zoo_export as ZE
    from mscnn_torch.config import zoo_import as ZI
    from mscnn_torch.data import pipeline as P
    from mscnn_torch.data.resize import resize_bilinear_u8
    from mscnn_torch.io import caffemodel as CM
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo

    def write_nets(root, wf):
        t0 = time.perf_counter()
        paths = {}
        for stage in (1, 2):
            cfg, tspec, aug, dspec, sspec, lspec = flagship_training_specs(stage, root)
            net = os.path.join(root, f"trainval_{'1st' if stage == 1 else '2nd'}.prototxt")
            with open(net, "w") as f:
                f.write(ZE.trainval_prototxt(cfg, tspec, aug, dspec, source=wf))
            solver = os.path.join(root, f"solver_{'1st' if stage == 1 else '2nd'}.prototxt")
            with open(solver, "w") as f:
                f.write(ZE.solver_prototxt(sspec, lspec, net=net, random_seed=SEED))
            # the texts import back to the zoo config and the specs
            icfg, itspec, iaug, idspec, src = ZI.model_from_prototxt(net)
            if stage == 1:   # no ROI layer in stage 1: the importer's ROI default
                icfg = dataclasses.replace(icfg, roi_spatial_scale=cfg.roi_spatial_scale)
            if dataclasses.replace(icfg, name=cfg.name, extra_layers=cfg.extra_layers) \
                    != cfg or sorted(icfg.extra_layers) != sorted(cfg.extra_layers) \
                    or (itspec, iaug, idspec, src) != (tspec, aug, dspec, wf) \
                    or ZI.solver_from_prototxt(solver) != sspec:
                fail(f"{tag}: the stage-{stage} prototxts do not import back to "
                     f"{cfg.name} and its specs")
            paths[stage] = (net, solver, lspec.snapshot_prefix)
        log(f"{tag}: {TRAIN_IMAGES} synthetic KITTI images {KITTI_HW[0]}x{KITTI_HW[1]} "
            f"({os.path.basename(wf)}), trainval_1st/2nd and solver_1st/2nd from "
            f"zoo.kitti_car_8s_768() import back to it "
            f"({time.perf_counter() - t0:.1f} s)")
        return paths

    def check_warm(build, s1, snap1, ref):
        """Stage 2 holds stage 1's every layer; the conv1-2 layers stay
        frozen through both stages, every other layer trains in both."""
        warm, _, _, _, cfg2, _ = build("--weights", snap1)
        # both solvers seed the init alike, so stage 2's fresh init is stage 1's
        fresh = build()[0]
        lm = M.param_lr_multipliers(s1, cfg2)
        frozen = sorted(n for n in s1 if all(v == 0.0 for v in lm[n].values()))
        copied = tree_diff(warm["params"], s1)
        if copied:
            fail(f"{tag}: stage 2's warm start differs from stage 1's snapshot: {copied}")
        # stage 1 trains the trunk past conv2 and the heads; the ROI head has
        # no gradient there (no ProposalTarget), and its weight decay alone
        # moves nothing at lr 5e-6
        moved = [n for n in s1 if tree_diff(fresh["params"], {n: s1[n]})]
        stage1_trained = [n for n in s1 if n not in frozen
                          and not n.startswith(("roi_c1", "fc6", "cls_pred", "bbox_pred"))]
        frozen1 = [n for n in frozen if n in moved]
        frozen2 = tree_diff(ref["params"], {n: s1[n] for n in frozen})
        trained2 = [n for n in s1 if n not in frozen
                    and not tree_diff(ref["params"], {n: s1[n]})]
        if frozen != ["conv1_1", "conv1_2", "conv2_1", "conv2_2"] or frozen1 or frozen2 \
                or trained2 or not set(stage1_trained) <= set(moved):
            fail(f"{tag}: frozen {frozen}; frozen layers moved in stage 1 {frozen1}, in "
                 f"stage 2 {frozen2}; trained in stage 1 but equal to the init "
                 f"{sorted(set(stage1_trained) - set(moved))}; trainable layers stage "
                 f"2 left as warm-started {trained2}")
        return (f"stage 2 warm-starts from {os.path.basename(snap1)}: all {len(s1)} "
                f"layers equal to it bit for bit, {len(moved)} differ from the fresh "
                f"init (every layer stage 1 trains); {', '.join(frozen)} bit-unchanged "
                f"through both stages; every trainable layer moved in stage 2")

    def extra(root, wf, paths, ref, out):
        # (c) stage 2's state as .caffemodel / .solverstate, read back
        t0 = time.perf_counter()
        cm = CKPT.snapshot_caffemodel(os.path.join(root, "bp"), ref, current_step=0)
        out["snapshot_caffemodel_ms"] = (time.perf_counter() - t0) * 1e3
        back = CKPT.restore_params(cm, {n: {k: torch.zeros_like(v) for k, v in p.items()}
                                        for n, p in ref["params"].items()})
        hist, it = CM.load_solverstate_history(
            cm.replace(".caffemodel", ".solverstate"),
            {"it": torch.zeros((), dtype=torch.int32),
             "h1": {n: {k: torch.zeros_like(v) for k, v in p.items()}
                    for n, p in ref["solver"]["h1"].items()}})
        bad = tree_diff(back, ref["params"]) + tree_diff(hist["h1"], ref["solver"]["h1"])
        if bad or it != 4:
            fail(f"{tag}: (c) the .caffemodel / .solverstate pair read back differs: "
                 f"{bad[:5]}, iter {it}")
        t0 = time.perf_counter()
        CKPT.snapshot(os.path.join(root, "dir"), ref)
        out["snapshot_torch_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"{tag}: (c) stage 2's state written as {os.path.basename(cm)} + "
            f".solverstate and read back: bit-equal (params, h1, iter 4); snapshot "
            f"{out['snapshot_torch_ms']:.1f} ms (port directory) / "
            f"{out['snapshot_caffemodel_ms']:.1f} ms (.caffemodel + .solverstate), "
            f"{sum(v.numel() for p in ref['params'].values() for v in p.values())} "
            f"params")
        # the host pipeline's parts on this machine's CPU: one image's resize
        # to 768x2560 (data/resize.py) and one batch of the dataset (read,
        # augment, assemble), each the median of 5
        aug2, dspec2 = ZI.model_from_prototxt(paths[2][0])[2:4]
        img = P.load_image(os.path.join(root, "000000.ppm"))
        rs = []
        for _ in range(5):
            t = time.perf_counter()
            resize_bilinear_u8(img, (2560, 768))
            rs.append(time.perf_counter() - t)
        ds = P.dataset_from_window_file(wf, dataclasses.replace(aug2, emit_uint8=True),
                                        dspec2)
        bs = []
        for _ in range(5):
            t = time.perf_counter()
            ds.next_batch()
            bs.append(time.perf_counter() - t)
        out["resize_ms"] = statistics.median(rs) * 1e3
        out["batch_ms"] = statistics.median(bs) * 1e3
        log(f"{tag}: host pipeline on this machine's CPU: resize "
            f"{KITTI_HW[0]}x{KITTI_HW[1]} -> 768x2560 {out['resize_ms']:.2f} ms an "
            f"image, one batch of {BATCH} (read, augment, assemble) "
            f"{out['batch_ms']:.2f} ms (medians of 5)")

    return train2_entry_point(
        tag, dev, counts, zero_counts, PROF, seed=SEED + 13,
        train_hw=zoo.kitti_car_8s_768().input_hw,
        write_nets=write_nets, check_warm=check_warm,
        loss_keys=("loss", "loss_cls", "loss_bbox"), exact_resume=False,
        timed_iters=harness.pop("timed_iters", 10), extra=extra, **harness)


CASCADE_HW = (576, 1920)      # kitti_car/cascade-mscnn-7s-576-2x deploy
WIDERFACE_HW = (1024, 1024)   # examples/profile_widerface_stages.py:69
CASCADE_TRAIN_HW = (576, 768)


def nonzero_biases(params, seed):
    """Every float bias of the tree replaced by seeded N(0, 0.05) values
    (init_params gives zeros)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {n: {k: (torch.randn(v.shape, generator=g) * 0.05).to(v.device, v.dtype)
                if k == "b" else v for k, v in p.items()} for n, p in params.items()}


def cascade_bf16(maker, **kw):
    """A zoo cascade in the deploy configuration the phase runs: bf16, the
    fused conv1 block (K2)."""
    ccfg = maker(deploy=True)
    base = dataclasses.replace(ccfg.base, compute_dtype="bfloat16", pallas_conv1=True,
                               **kw)
    return dataclasses.replace(ccfg, base=base)


def hold_to_plain(sink, tag, out):
    """Hold every launch recorded in `sink` to its kernel's plain version on
    the same tensors: K1 equal (`nms_equal`), K2 by `conv1_compare`, K4
    equal with its int8 copies. Folds the errors into out ("nms_err",
    "conv1_err", "conv1_share", "int8_err"); returns a log line."""
    import torch

    from mscnn_torch.ops import nms as nms_ops
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import int8_kernel as IK

    for a, kw, got in sink["nms"]:
        want = nms_ops.nms_xywh_plain(*a, **kw)
        if not nms_equal(got, want):
            fail(f"{tag}: K1 != plain at P={a[0].shape[0]} N={a[0].shape[1]}")
        out["nms_err"] = max(out["nms_err"], nms_err(got, want))
    for a, got in sink["conv1"]:
        want = CK.conv1_pool_plain(*a).float()
        err, tol, eq, ulps, ok = conv1_compare(got.float(), want)
        if not ok:
            fail(f"{tag}: K2 != plain at {tuple(a[0].shape)} (err {err}, bit-equal "
                 f"share {eq})")
        out["conv1_err"] = max(out["conv1_err"], err)
        out["conv1_share"] = min(out["conv1_share"], eq)
    for a, kw, got in sink["int8"]:
        want = IK.int8_conv_plain(*a, **kw)
        pairs = [(got, want)] if torch.is_tensor(want) else \
            [(got[0], want[0])] + list(zip(got[1], want[1]))
        if (not torch.is_tensor(want)) and len(got[1]) != len(want[1]):
            fail(f"{tag}: K4 wrote {len(got[1])} int8 copies, plain {len(want[1])}")
        for g, w in pairs:
            if not torch.equal(g, w):
                fail(f"{tag}: K4 != plain at x {tuple(a[0].shape)} w {tuple(a[1].shape)}")
            out["int8_err"] = max(out["int8_err"], (g.double() - w.double()).abs()
                                  .max().item() if g.numel() else 0.0)
    return (f"K1 {len(sink['nms'])}, K2 {len(sink['conv1'])}, K4 {len(sink['int8'])} "
            f"launches equal to their plain versions on the run's tensors")


def cascade_deploy(dev, counts, zero_counts, PROF, rec):
    """Phase 14: the cascade deploy paths (module notes). rec(on, sink)
    switches the kernels' recording wrappers on or off. Returns the
    figures the kernels line and the log use."""
    import numpy as np
    import torch

    from mscnn_torch import inference as I
    from mscnn_torch.examples import profile_cascade_stages as PCS
    from mscnn_torch.models import cascade as CC
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo
    from mscnn_torch.ops import quant as Q

    out = {"nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0, "int8_err": 0.0}

    def run_path(tag, params, ccfg, imgs, expect):
        """detect_batch(cascade=) on the images: launches from this run
        alone, each kernel held to its plain version, KITTI text."""
        sink = {"nms": [], "conv1": [], "int8": []}
        rec(True, sink)
        zero_counts()
        t0 = time.perf_counter()
        dets = I.detect_batch(params, imgs, ccfg.base, I.DetectSpec(), cascade=ccfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = counts()
        rec(False, sink)
        if launches != expect:
            fail(f"{tag}: launches {launches}, expected {expect}")
        nc = ccfg.base.num_classes
        for d in dets:
            if d["boxes"].shape != (nc - 1, 100, 4) or not np.isfinite(d["boxes"]).all() \
                    or not np.isfinite(d["scores"]).all() or \
                    d["proposals"].shape != (ccfg.base.proposal.max_out, 4):
                fail(f"{tag}: detections {d['boxes'].shape}, proposals "
                     f"{d['proposals'].shape}, or not finite")
        held = hold_to_plain(sink, tag, out)
        names = I.KITTI_CLASS_NAMES["kitti_car"] if nc == 5 else ("bg", "face")
        lines, first_line = check_kitti(I, {k: [d[k] for d in dets] for k in
                                            ("boxes", "scores", "valid")}, len(imgs), names)
        log(f"{tag}: first call {first:.2f} s, launches {launches}; {held}; "
            f"{sum(int(d['proposal_valid'].sum()) for d in dets)} proposals, "
            f"{lines} KITTI lines over {len(imgs)} images, first: {first_line or '(none)'}")
        del sink
        return launches, dets

    def figures(tag, params, ccfg, img_u8):
        """Stage split (CUDA events), host-clock step, img/s, peak memory and
        a profiler window of two steps with its named-range counts."""
        B = img_u8.shape[0]
        h, w = ccfg.base.input_hw
        ratios = torch.ones((B, 2))
        orig = torch.tensor([[float(w), float(h)]] * B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split = PCS.stage_split(params, img_u8, ccfg, ratios, orig, iters=3)
        step = PCS.step_ms(params, img_u8, ccfg, ratios, orig, iters=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        names = {}
        busy = trace_window(
            PROF, lambda: I._cascade_detect(params, img_u8, ratios, orig, ccfg,
                                            I.DetectSpec(), MEAN),
            f"cascade_step_{tag}", f"two {tag} cascade detect steps",
            "the step ms is a host-clock time", annotations=names)
        log(f"{tag}: stage split (CUDA events, median of 3, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; step {step:.2f} ms (host clock, median of 5) = {B * 1e3 / step:.2f} "
              f"img/s; peak {peak:.2f} GiB; busy share "
            + (f"{busy:.4f}" if busy is not None else "not measured"))
        return {"split": split, "step_ms": step, "img_s": B * 1e3 / step,
                "peak_gib": peak, "busy": busy,
                "ranges": {k: v for k, v in names.items() if k.startswith("cascade_")}}

    gen = torch.Generator().manual_seed(SEED + 14)
    t0 = time.perf_counter()
    ccfg = cascade_bf16(zoo.cascade_kitti_car_7s_576_2x)
    p32 = nonzero_biases(CC.init_params(gen, ccfg, device=dev), SEED + 15)
    params = M.cast_params(p32, torch.bfloat16)
    H, W = ccfg.base.input_hw
    imgs = torch.randint(0, 256, (BATCH, H, W, 3), generator=gen, dtype=torch.uint8)
    log(f"cascade: {ccfg.base.name} deploy {H}x{W}, max_out {ccfg.base.proposal.max_out}, "
        f"{sum(t.numel() for p in params.values() for t in p.values())} params (seeded "
        f"random, nonzero biases, bf16) in {time.perf_counter() - t0:.1f} s")

    # -- KITTI cascade, bf16 + K2: the batch, then detect_cascade at batch 1
    launches, dets = run_path("cascade kitti", params, ccfg,
                              list(imgs.numpy()), {"nms": 2, "conv1_pool": 1,
                                                   "int8_gemm": 0, "conv1_v5": 0})
    out["launches"] = launches
    zero_counts()
    one = I.detect_cascade(params, imgs[0].numpy(), ccfg)
    one_launches = counts()
    if one_launches["nms"] != 2 or one_launches["conv1_pool"] != 1 or \
            not np.isfinite(one["boxes"]).all():
        fail(f"cascade detect_cascade: launches {one_launches}")
    # the batch-1 call on the batch's first image (bf16 convs at another
    # batch size sum in another order, and random weights give near-equal
    # scores, so the kept slots may come in another order: counts only)
    log(f"cascade kitti: detect_cascade at batch 1: launches {one_launches}; "
        f"{int(one['valid'].sum())} detections (the batched call: "
        f"{int(dets[0]['valid'].sum())} on that image)")
    out["kitti"] = figures("kitti", params, ccfg, imgs.to(dev))
    rng_ = out["kitti"]["ranges"]
    if rng_.get("cascade_sliding_max_table") != 2 or any(
            k.startswith("cascade_rescore") for k in rng_) or \
            sum(v for k, v in rng_.items() if k.startswith("cascade_roi_head")) != 6:
        fail(f"cascade kitti: named ranges over two steps {rng_}: expected 2 "
             f"sliding-max tables, 6 stage heads, no re-score head")
    log(f"cascade kitti: two steps' named ranges {rng_}: the sliding-max table "
        f"once a forward, no ensemble re-score head (ensemble_avg False)")
    del params

    # -- int8 cascade, as the JAX CLI calibrates it (cli.py:489-545): the
    # trunk (conv1 included: --int8 leaves conv1 unfused) at percentile
    # 99.9, then calibrate_roi_head_scales(ccfg=) on the int8 trunk
    t0 = time.perf_counter()
    fcfg = dataclasses.replace(ccfg.base, pallas_conv1=False)
    cal = np.random.RandomState(SEED + 16).randn(1, H, W, 3).astype(np.float32) * 40.0
    scales = Q.calibrate_trunk_scales(p32, fcfg, cal, include_conv1=True)
    q = Q.quantize_trunk(p32, scales)
    qbase = dataclasses.replace(fcfg, int8_trunk=True)
    hscales = Q.calibrate_roi_head_scales(q, qbase, cal,
                                          ccfg=dataclasses.replace(ccfg, base=qbase))
    q = Q.quantize_roi_heads(q, hscales)
    ccfg8 = dataclasses.replace(ccfg, base=dataclasses.replace(qbase, int8_roi_head=True))
    params8 = M.cast_params(q, torch.bfloat16)
    del p32, q
    torch.cuda.empty_cache()
    n8 = len(scales) + 2 * len(ccfg.stages)
    log(f"cascade int8: {len(scales)} trunk layers + {sorted(hscales)} calibrated in "
        f"{time.perf_counter() - t0:.1f} s; expected K4 launches a step: {len(scales)} "
        f"trunk + 2 x {len(ccfg.stages)} stages = {n8}")
    launches8, _ = run_path("cascade int8", params8, ccfg8, list(imgs.numpy()),
                            {"nms": 2, "conv1_pool": 0, "int8_gemm": n8, "conv1_v5": 0})
    out["launches8"] = launches8
    out["int8"] = figures("int8", params8, ccfg8, imgs.to(dev))
    del params8
    torch.cuda.empty_cache()

    # -- widerface cascade-12s-align at 1024x1024, batch 1: ROIAlign, the
    # ensemble re-score
    wcfg = cascade_bf16(zoo.cascade_widerface_12s_align, input_hw=WIDERFACE_HW)
    wparams = M.cast_params(nonzero_biases(CC.init_params(gen, wcfg, device=dev),
                                           SEED + 17), torch.bfloat16)
    wimg = torch.randint(0, 256, (1, *WIDERFACE_HW, 3), generator=gen, dtype=torch.uint8)
    wl, _ = run_path("cascade widerface align", wparams, wcfg, list(wimg.numpy()),
                     {"nms": 2, "conv1_pool": 1, "int8_gemm": 0, "conv1_v5": 0})
    out["launches_wf"] = wl
    out["widerface"] = figures("widerface", wparams, wcfg, wimg.to(dev))
    rng_ = out["widerface"]["ranges"]
    if "cascade_sliding_max_table" in rng_ or \
            sum(v for k, v in rng_.items() if k.startswith("cascade_rescore")) != 4:
        fail(f"cascade widerface: named ranges over two steps {rng_}: expected no "
             f"sliding-max table (ROIAlign) and 4 re-score heads")
    del wparams
    torch.cuda.empty_cache()

    # -- a tiny float32 cascade on the card and on the CPU: ROIAlign and the
    # ensemble on and off
    tiny = dataclasses.replace(zoo.tiny_test_config(), fc_dim=256)
    timg = torch.randint(0, 256, (2, *tiny.input_hw, 3),
                         generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    tx = timg.float() - torch.tensor(MEAN)
    for align in (False, True):
        tcc = CC.CascadeConfig(base=dataclasses.replace(tiny, roi_align=align))
        tp = nonzero_biases(CC.init_params(torch.Generator().manual_seed(SEED), tcc,
                                           device="cpu"), SEED + 18)
        dp = {k: {n: t.to(dev) for n, t in p.items()} for k, p in tp.items()}
        for ens in (False, True):
            tcc = dataclasses.replace(tcc, ensemble_avg=ens)
            ref = I.make_cascade_forward(tp, tcc)(tp, tx)
            got = I.make_cascade_forward(dp, tcc)(dp, tx.to(dev))
            if set(ref) != set(got) or not torch.equal(got["roi_valid"].cpu(),
                                                       ref["roi_valid"]):
                fail(f"tiny cascade (align {align}, ensemble {ens}): outputs or valid "
                     f"flags differ between card and CPU")
            for k in ("rois", "cls_pred", "bbox_pred") + (("cls_prob",) if ens else ()):
                if not torch.allclose(got[k].cpu(), ref[k], rtol=1e-4, atol=1e-3):
                    err = (got[k].cpu() - ref[k]).abs().max().item()
                    fail(f"tiny cascade (align {align}, ensemble {ens}): {k} differs "
                         f"between card and CPU ({err})")
    log("tiny cascade float32 (ROIAlign off / on x ensemble off / on): card agrees "
        "with the CPU")
    if jax_loaded():
        fail("the cascade deploy phase imported jax or the JAX package")
    return out

def cascade_training(dev, counts, zero_counts, PROF):
    """Phase 15: `cli train2` from the plain kitti_car_7s_576_2x trainval
    (stage 1) to its cascade trainval (stage 2), on phase 13's harness.
    Returns the figures the kernels line and the log use."""
    from mscnn_torch.config import zoo_export as ZE
    from mscnn_torch.config import zoo_import as ZI
    from mscnn_torch.data.augment import AugmentSpec
    from mscnn_torch.data.pipeline import DatasetSpec
    from mscnn_torch.models import zoo
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train.solver import SolverSpec
    from mscnn_torch.train.train_step import TrainSpec

    tag = "cascade train"
    ccfg = zoo.cascade_kitti_car_7s_576_2x()
    cfg = ccfg.base
    if cfg.input_hw != CASCADE_TRAIN_HW:
        fail(f"{tag}: the zoo's training geometry is {cfg.input_hw}")

    def write_nets(root, wf):
        # the kitti_car trainval's augmentation shape, resize to the deploy size
        aug = AugmentSpec(template_hw=cfg.input_hw, resize_hw=CASCADE_HW, mirror=True,
                          do_multiple_scale=True, min_scale=60, max_scale=480,
                          min_gt_height=35.0)
        dspec = DatasetSpec(batch_size=BATCH)
        sspec = SolverSpec(type="sgd", base_lr=5e-6, lr_policy="step", gamma=0.1,
                           stepsize=10000, max_iter=4, momentum=0.9, weight_decay=5e-4)
        paths = {}
        for stage in (1, 2):
            if stage == 1:
                tspec = TrainSpec(stage=1, sample_mode="random", roi_bg_thr_hg=0.5)
                text = ZE.trainval_prototxt(cfg, tspec, aug, dspec, source=wf)
            else:
                tspec = TrainSpec(stage=2)
                text = ZE.cascade_trainval_prototxt(ccfg, tspec, aug, dspec, source=wf)
            net = os.path.join(root, f"trainval_{stage}.prototxt")
            with open(net, "w") as f:
                f.write(text)
            lspec = LP.LoopSpec(max_iter=4, display=2, snapshot=2 if stage == 2 else 0,
                                snapshot_prefix=os.path.join(root, f"c{stage}"))
            solver = os.path.join(root, f"solver_{stage}.prototxt")
            with open(solver, "w") as f:
                f.write(ZE.solver_prototxt(sspec, lspec, net=net, random_seed=SEED))
            paths[stage] = (net, solver, lspec.snapshot_prefix)
        icc = ZI.cascade_from_prototxt(paths[2][0])[0]
        if not ZI.is_cascade_prototxt(paths[2][0]) or icc.stages != ccfg.stages:
            fail(f"{tag}: the cascade trainval imports to {icc.stages}")
        log(f"{tag}: {TRAIN_IMAGES} synthetic KITTI images + window file, "
            f"{cfg.name}'s trainval_1st and its cascade trainval from zoo_export; the "
            f"cascade text imports back to the zoo's {len(ccfg.stages)} stages")
        return paths

    def check_warm(build, s1, snap1, ref):
        """Every stage-1 layer whose shape the cascade shares, by name."""
        warm = build("--weights", snap1)[0]["params"]
        shared = {n: p for n, p in s1.items() if n in warm
                  and all(warm[n][k].shape == v.shape for k, v in p.items())}
        copied = tree_diff(warm, shared)
        fresh8 = [n for n in s1 if n in warm and n not in shared]
        if copied or fresh8 != ["bbox_pred"] or not {"roi_c1_2nd", "fc6_3rd"} <= set(warm):
            fail(f"{tag}: warm start: not copied {copied}, not shared {fresh8}")
        return (f"stage 2 warm-starts from {os.path.basename(snap1)}: {len(shared)} "
                f"layers equal to it bit for bit; bbox_pred (8-wide in the cascade) "
                f"and the _2nd / _3rd heads fresh")

    return train2_entry_point(
        tag, dev, counts, zero_counts, PROF, seed=SEED + 15, train_hw=cfg.input_hw,
        write_nets=write_nets, check_warm=check_warm,
        loss_keys=("loss",) + tuple(f"loss_{k}{t}" for k in ("cls", "bbox")
                                    for t in ("_1st", "_2nd", "_3rd")),
        exact_resume=True, timed_iters=8)


# -- phase 16: the deploy entry points ----------------------------------------

FLAGSHIP_256 = "kitti_car/mscnn-8s-768-trainval@max_out256"   # registered by phase 16
ENTRY_IMAGES = 8


def png_bytes(bgr, filters=(0, 1, 2, 3, 4)):
    """An 8-bit RGB PNG of an HxWx3 BGR uint8 image whose rows cycle through
    `filters` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), as the PNG
    specification defines each predictor."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = bgr.shape
    x = np.ascontiguousarray(bgr[:, :, ::-1]).reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    f = np.asarray([filters[y % len(filters)] for y in range(h)])
    pred = np.choose(f[:, None], preds)
    raw = np.concatenate([f[:, None], (x - pred) & 255], 1).astype(np.uint8)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                                  0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write_kitti_pngs(root, n, seed):
    """n seeded KITTI-size PNG images (image_2/) with 1-5 flat car boxes on a
    noisy background, their KITTI label files (label_2/) and the images as
    decoded; every PNG cycles through the five row filters."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = KITTI_HW
    img_dir, gt_dir = os.path.join(root, "image_2"), os.path.join(root, "label_2")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    images = []
    for i in range(n):
        yy, xx = np.mgrid[:h, :w]
        img = ((yy // 3 + xx // 5)[..., None] % 64 + 80
               + rng.randint(0, 60, (h, w, 3))).astype(np.uint8)
        rows = []
        for _ in range(rng.randint(1, 6)):
            bw, bh = rng.randint(w // 20, w // 4), rng.randint(h // 9, h * 2 // 5)
            x1, y1 = rng.randint(0, w - bw), rng.randint(h // 4, h - bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
            rows.append(f"Car 0.00 0 -10 {x1:.2f} {y1:.2f} {x1 + bw - 1:.2f} "
                        f"{y1 + bh - 1:.2f} -1 -1 -1 -1000 -1000 -1000 -10")
        with open(os.path.join(img_dir, f"{i:06d}.png"), "wb") as f:
            f.write(png_bytes(img, filters=(i % 5, 0, 1, 2, 3, 4)))
        with open(os.path.join(gt_dir, f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        images.append(img)
    return img_dir, gt_dir, images


def same_outputs(tag, got, want):
    """Hold an artifact's output dict to the eager forward's: bit-equal, or
    (printing the differing count) within 1e-4 of max|ref| with the same
    valid flags. Returns the number of differing values."""
    import torch
    differ = 0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{tag}: output {k} is {tuple(g.shape)} {g.dtype}, eager "
                 f"{tuple(w.shape)} {w.dtype}")
        if torch.equal(g, w):
            continue
        n = int((g != w).sum())
        differ += n
        if w.dtype == torch.bool:
            fail(f"{tag}: {n} {k} flags differ from the eager forward")
        ref = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        log(f"{tag}: {k}: {n} of {w.numel()} values differ from the eager forward, "
            f"max err {err:.3g} (max|ref| {ref:.4g})")
        if err > 1e-4 * max(ref, 1.0):
            fail(f"{tag}: {k} differs from the eager forward by {err}")
    return differ


def cli_run(out, rec, counts, zero_counts, tag, *argv, expect=None):
    """`mscnn_torch.cli.main(argv)` in this process with the kernels'
    launches counted from this run alone and every launch recorded (rec);
    the launches go to out["launches"][tag]. Returns (stdout, launches,
    sink, seconds)."""
    import contextlib
    import io

    import torch

    from mscnn_torch import cli

    sink = {"nms": [], "conv1": [], "int8": []}
    buf = io.StringIO()
    rec(True, sink)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    rec(False, sink)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  [{tag}] {line}")
    if rc != 0:
        fail(f"{tag}: `{' '.join(map(str, argv))}` returned {rc}")
    if expect is not None and any(launches[k] != v for k, v in expect.items()):
        fail(f"{tag}: launches {launches}, expected {expect}")
    out["launches"][tag] = launches
    return text, launches, sink, seconds


def deploy_entry_points(dev, counts, zero_counts, PROF, rec):
    """Phase 16 (module notes): the port's deploy commands through
    `mscnn_torch.cli.main`, in this process, at the flagship's full width.
    rec(on, sink) switches the kernels' recording wrappers on or off; every
    recorded launch is held to its plain version (`hold_to_plain`).
    Returns the figures the kernels line and the log use, and (for phase
    17) its directory, snapshot and batch-4 bf16 artifact, which the caller
    removes."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mscnn_torch import inference as I
    from mscnn_torch import serve as SV
    from mscnn_torch.data import image_io
    from mscnn_torch.data.resize import resize_bilinear_u8
    from mscnn_torch.io import aot
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import cascade as CC
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import int8_kernel as IK
    from mscnn_torch.ops.kernels import nms_kernel as NK
    from mscnn_torch.ops.kernels import ops as KO

    t_phase = time.perf_counter()
    zoo.REGISTRY[FLAGSHIP_256] = lambda deploy=False: zoo.kitti_car_8s_768(
        deploy=deploy, max_out=256)
    root = tempfile.mkdtemp(prefix="mscnn_entry_")
    out = {"launches": {}, "nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0,
           "int8_err": 0.0}
    spec = I.DetectSpec()
    names = I.KITTI_CLASS_NAMES["kitti_car"]

    run_cli = functools.partial(cli_run, out, rec, counts, zero_counts)

    def steady(text):
        m = re.search(r"\(([0-9.]+) s/img steady-state", text)
        return float(m.group(1)) if m else None

    # -- (a) 8 seeded KITTI-size PNGs (all five row filters), their labels,
    # and a port snapshot of seeded weights with nonzero biases
    t0 = time.perf_counter()
    img_dir, gt_dir, made = write_kitti_pngs(root, ENTRY_IMAGES, SEED + 30)
    decoded = [image_io.imread(os.path.join(img_dir, f"{i:06d}.png"))
               for i in range(ENTRY_IMAGES)]
    if any(not np.array_equal(a, b) for a, b in zip(decoded, made)):
        fail("entry: image_io does not decode the phase's PNGs to the images written")
    gen = torch.Generator().manual_seed(SEED + 31)
    cfg32 = zoo.get(FLAGSHIP_256, deploy=True)
    p32 = nonzero_biases(M.init_params(gen, cfg32, device=dev), SEED + 32)
    snap = CKPT.snapshot(os.path.join(root, "flagship"), {"params": p32, "solver": {
        "it": torch.tensor(0, dtype=torch.int32)}}, 0)
    log(f"entry: {ENTRY_IMAGES} PNGs {KITTI_HW[0]}x{KITTI_HW[1]} (filters 0-4) decoded "
        f"bit for bit by data/image_io.py, labels, snapshot {snap} in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (b) detect --bf16 --conv1 auto: the labels detect_batch writes on the
    # same decoded images, each K1 / K2 launch held to its plain version
    det_b = os.path.join(root, "det_bf16")
    text, launches, sink, secs = run_cli(
        "detect bf16", "detect", "--zoo", FLAGSHIP_256, "--weights", snap, "--bf16",
        "--conv1", "auto", "--image-dir", img_dir, "--output-dir", det_b,
        expect={"nms": 2 * ENTRY_IMAGES, "conv1_pool": ENTRY_IMAGES, "int8_gemm": 0})
    held = hold_to_plain(sink, "entry detect bf16", out)
    del sink
    cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16", pallas_conv1=True)
    params = M.cast_params(p32, torch.bfloat16)
    ref_dir = os.path.join(root, "ref_bf16")
    for i, img in enumerate(decoded):
        det = I.detect_batch(params, [img], cfg, spec)[0]
        I.write_kitti_labels(I.detections_to_kitti(det, names), ref_dir, i)
    for i in range(ENTRY_IMAGES):
        with open(os.path.join(det_b, f"{i:06d}.txt")) as a, \
                open(os.path.join(ref_dir, f"{i:06d}.txt")) as b:
            if a.read() != b.read():
                fail(f"entry detect bf16: {i:06d}.txt differs from detect_batch's labels")
    out["detect_s_img"] = steady(text)
    n_lines = sum(len(open(os.path.join(det_b, f)).read().splitlines())
                  for f in os.listdir(det_b))
    log(f"entry detect bf16: {secs:.2f} s for {ENTRY_IMAGES} images, launches {launches}; "
        f"{held}; {n_lines} label lines equal to detect_batch's")

    # -- (c) detect --int8 --int8-heads: 17 K4 launches an image (and the head
    # calibration's 15 a calibration image), each held to its plain version.
    # Two calibration images: the trunk's calibration takes each input blob's
    # 99.9th percentile on the host, as JAX does (~2 s a full-size image)
    n8 = 2
    text, launches, sink, secs = run_cli(
        "detect int8", "detect", "--zoo", FLAGSHIP_256, "--weights", snap, "--bf16",
        "--int8", "--int8-heads", "--calib-images", n8, "--image-dir", img_dir,
        "--iterations", n8, "--output-dir", os.path.join(root, "det_int8"),
        expect={"int8_gemm": 17 * n8 + 15 * n8, "conv1_pool": 0})
    held = hold_to_plain(sink, "entry detect int8", out)
    del sink
    torch.cuda.empty_cache()
    out["detect8_s_img"] = steady(text)
    log(f"entry detect int8: {secs:.2f} s for {n8} images ({n8} calibration images), "
        f"launches {launches} = 17 x {n8} + 15 x {n8} (head calibration); {held}")

    # -- (d) compile (bf16; int8 trunk + heads) at batch 4, detect --compiled;
    # the artifacts against the eager forward on the same batch
    arts = {}
    for tag, extra in (("bf16", []), ("int8", ["--int8", "--int8-heads", "--calib-dir",
                                               img_dir, "--calib-images", n8])):
        arts[tag] = os.path.join(root, f"art_{tag}")
        text, _, _, secs = run_cli(f"compile {tag}", "compile", "--zoo", FLAGSHIP_256,
                                   "--weights", snap, "--bf16", "--batch", BATCH,
                                   "-o", arts[tag], *extra)
        out[f"compile_{tag}_s"] = secs
    det_c = os.path.join(root, "det_compiled")
    text, launches, sink, secs = run_cli(
        "detect compiled", "detect", "--compiled", arts["bf16"], "--image-dir", img_dir,
        "--output-dir", det_c, expect={"nms": 2 * ENTRY_IMAGES // BATCH,
                                       "conv1_pool": ENTRY_IMAGES // BATCH})
    held = hold_to_plain(sink, "entry detect compiled", out)
    del sink
    out["detect_compiled_s_img"] = steady(text)
    log(f"entry detect --compiled: {secs:.2f} s for {ENTRY_IMAGES} images (load "
        f"included), launches {launches}; {held}")

    cfgs = {"bf16": cfg, "int8": dataclasses.replace(
        cfg32, compute_dtype="bfloat16", int8_trunk=True, int8_roi_head=True)}
    expect = {"bf16": {"nms": 2, "conv1_pool": 1, "int8_gemm": 0},
              "int8": {"nms": 2, "conv1_pool": 0, "int8_gemm": 17}}
    out["artifact"] = {}
    for tag in ("bf16", "int8"):
        t0 = time.perf_counter()
        c = aot.load_deploy(arts[tag])
        load_s = time.perf_counter() - t0
        batch = c.inputs([c._prep(im) for im in decoded[:BATCH]])
        eager = I.make_e2e_forward(c.params, cfgs[tag], spec)
        want = eager(c.params, *batch)
        sink = {"nms": [], "conv1": [], "int8": []}
        rec(True, sink)
        zero_counts()
        got = c(*batch)
        torch.cuda.synchronize()
        launches = counts()
        rec(False, sink)
        if launches != {**expect[tag], "conv1_v5": 0}:
            fail(f"entry artifact {tag}: launches {launches}, expected {expect[tag]}")
        held = hold_to_plain(sink, f"entry artifact {tag}", out)
        del sink
        differ = same_outputs(f"entry artifact {tag}", got, want)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            c(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # (e) the step: artifact against the eager forward, CUDA events
        art_ms = cuda_ms(lambda: c(*batch))
        eager_ms = cuda_ms(lambda: eager(c.params, *batch))
        # the host's enqueue time of a call (no synchronise inside it), the
        # median of 5, the two forwards in turns
        enq = ([], [])
        for _ in range(5):
            for j, fn in enumerate((lambda: c(*batch), lambda: eager(c.params, *batch))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                enq[j].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host = [statistics.median(e) for e in enq]
        enq_ways = program_enqueue_ms(c, batch)
        busy = trace_window(PROF, lambda: c(*batch), f"artifact_{tag}",
                            f"two {tag} artifact calls", "the step ms is CUDA events")
        out["artifact"][tag] = {
            "launches": launches, "ms": art_ms, "eager_ms": eager_ms,
            "img_s": BATCH * 1e3 / art_ms, "eager_img_s": BATCH * 1e3 / eager_ms,
            "host_ms": host[0], "eager_host_ms": host[1], "enqueue_ms": enq_ways,
            "busy": busy,
            "differ": differ, "load_s": load_s, "kernel_ops": c.meta["kernel_ops"]}
        log(f"entry artifact {tag}: loaded in {load_s:.2f} s, graph ops "
            f"{c.meta['kernel_ops']}, launches {launches}; {held}; "
            + ("bit-equal to the eager forward" if not differ else
               f"{differ} values differ from the eager forward (within 1e-4)")
            + f"; one call under sync debug mode 'error': no host sync; step "
              f"{art_ms:.3f} ms (eager {eager_ms:.3f} ms, CUDA events, median of 5) = "
              f"{BATCH * 1e3 / art_ms:.2f} img/s; host enqueue {host[0]:.2f} ms (eager "
              f"{host[1]:.2f} ms, median of 5; the program alone, median of 20: module "
              f"{enq_ways['module']:.2f} ms, input checks off "
              f"{enq_ways['unchecked']:.2f} ms, graph on pre-flattened inputs "
              f"{enq_ways['flat']:.2f} ms); busy share "
            + (f"{busy:.4f}" if busy is not None else "not measured"))
        if tag == "bf16":
            compiled = c
            bf16_batch = batch
        else:
            del c
        del eager, want, got
        torch.cuda.empty_cache()

    # the op layer's host cost a call: the operator against its launch
    # function called directly, on small inputs (host clock, 200 calls)
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    bx = torch.rand((4, 2000, 4), generator=g, device=dev) * 500
    sc = torch.rand((4, 2000), generator=g, device=dev)
    va = sc > 0.1
    x1 = torch.randn((1, 16, 16, 3), generator=g, device=dev).bfloat16()
    w1, b1 = params["conv1_1"]["w"], params["conv1_1"]["b"]
    w2, b2 = params["conv1_2"]["w"], params["conv1_2"]["b"]
    xq = torch.randint(-127, 128, (1, 8, 8, 64), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (64, 3, 3, 64), generator=g, device=dev,
                       dtype=torch.int8)
    xs, ws = torch.tensor(0.01, device=dev), torch.full((64,), 0.01, device=dev)
    pairs = {
        "nms_xywh": (lambda: KO.nms_xywh(bx, sc, va, 0.65, "iou", 256),
                     lambda: NK.nms_xywh_cuda(bx, sc, va, iou_thr=0.65, mode="iou",
                                              max_out=256)),
        "conv1_pool": (lambda: KO.conv1_pool(x1, w1, b1, w2, b2),
                       lambda: CK.conv1_pool_cuda(x1, w1, b1, w2, b2)),
        "int8_conv": (lambda: KO.int8_conv(xq, wq, xs, ws, None, [1, 1], torch.bfloat16,
                                           True, [], []),
                      lambda: IK.int8_conv_cuda(xq, wq, xs, ws, None, padding=(1, 1),
                                                out_dtype=torch.bfloat16, relu=True)),
    }
    out["op_overhead_us"] = {}
    for name, (op, direct) in pairs.items():
        per = []
        for fn in (op, direct, op, direct):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            per.append((t1 - t0) / 200 * 1e6)
        op_us, direct_us = min(per[0], per[2]), min(per[1], per[3])
        out["op_overhead_us"][name] = {"op_us": op_us, "direct_us": direct_us,
                                       "overhead_us": op_us - direct_us}
    log("entry op layer, host time a call (200 calls, best of 2): " + ", ".join(
        f"{k} {v['op_us']:.1f} us through the operator, {v['direct_us']:.1f} us "
        f"direct ({v['overhead_us']:+.1f} us)" for k, v in out["op_overhead_us"].items()))

    # detect's steady s/img split: decode, resize (host), the batch-1 step
    dec, rsz = [], []
    for i in range(ENTRY_IMAGES):
        t0 = time.perf_counter()
        im = image_io.imread(os.path.join(img_dir, f"{i:06d}.png"))
        t1 = time.perf_counter()
        resize_bilinear_u8(im, (cfg.input_hw[1], cfg.input_hw[0]))
        t2 = time.perf_counter()
        dec.append((t1 - t0) * 1e3)
        rsz.append((t2 - t1) * 1e3)
    one = [t[:1] for t in bf16_batch]
    e2e1 = I.make_e2e_forward(params, cfg, spec)
    dev_ms = cuda_ms(lambda: e2e1(params, *one))
    out["detect_split_ms"] = {"decode": statistics.median(dec),
                              "resize": statistics.median(rsz), "device": dev_ms}
    log(f"entry detect split (median, ms an image): decode {statistics.median(dec):.2f}"
        f" (data/image_io.py PNG), resize {statistics.median(rsz):.2f} (data/resize.py "
        f"to 768x2560), the batch-1 bf16 step {dev_ms:.3f} (CUDA events); the CLI's "
        f"steady state {out['detect_s_img']} s/img bf16, {out['detect8_s_img']} s/img "
        f"int8, {out['detect_compiled_s_img']} s/img from the batch-4 artifact")
    del e2e1, one

    # -- (f) serve the batch-4 artifact: 8 client threads, 16 PNG POSTs
    boot, ready = {}, threading.Event()

    def started(httpd):
        boot["httpd"] = httpd
        ready.set()

    threading.Thread(target=SV.serve, args=(arts["bf16"], 0), kwargs={
        "started": started, "linger_ms": 20.0}, daemon=True).start()
    if not ready.wait(300):
        fail("entry serve: the server did not start")
    httpd = boot["httpd"]
    port = httpd.server_address[1]
    bodies = [open(os.path.join(img_dir, f"{i:06d}.png"), "rb").read()
              for i in range(ENTRY_IMAGES)]

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/detect", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    # the serving split: wall and thread-CPU ms of each part, on its thread
    # (the handlers' PNG decode and response rows, the batcher's resize,
    # input copy and whole dispatch); the program call and the copy back
    # are the dispatch less the resize and the inputs
    split = {k: [] for k in ("decode", "respond", "resize", "inputs", "dispatch")}

    def timed(fn, key):
        def wrapped(*a, **kw):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                split[key].append(((time.perf_counter() - w0) * 1e3,
                                   (time.thread_time() - c0) * 1e3))
        return wrapped

    served_c = httpd.batcher.compiled
    plain_fns = (image_io.imdecode, SV.detections_json)
    image_io.imdecode = timed(image_io.imdecode, "decode")
    SV.detections_json = timed(SV.detections_json, "respond")
    for name, key in (("_prep", "resize"), ("inputs", "inputs"),
                      ("detect_many", "dispatch")):
        setattr(served_c, name, timed(getattr(served_c, name), key))
    try:
        post(bodies[0])   # warm-up
        for v in split.values():
            v.clear()
        cpu0 = time.process_time()
        before = (httpd.batcher.dispatches, httpd.batcher.served)
        results, lat, errs = {}, [], []
        barrier = threading.Barrier(8)

        def client(k):
            try:
                barrier.wait()
                for j in (k, (k + 4) % ENTRY_IMAGES):
                    t0 = time.perf_counter()
                    results[(k, j)] = post(bodies[j])
                    lat.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001
                errs.append((k, e))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - cpu0
        dispatches = httpd.batcher.dispatches - before[0]
        served = httpd.batcher.served - before[1]
    finally:
        httpd.shutdown()
        image_io.imdecode, SV.detections_json = plain_fns
    if errs or len(results) != 16 or served != 16:
        fail(f"entry serve: {len(results)} answers, {served} served, errors {errs[:2]}")
    if dispatches >= 16:
        fail(f"entry serve: {dispatches} device calls for 16 requests")
    max_err = 0.0
    for (k, j), res in results.items():
        want = SV.detections_json(compiled.detect(decoded[j]))
        if res["num"] != len(want) or [d["class_id"] for d in res["detections"]] != \
                [d["class_id"] for d in want]:
            fail(f"entry serve: request ({k}, {j}): {res['num']} detections, "
                 f"compiled.detect {len(want)}")
        for a, b in zip(res["detections"], want):
            err = max([abs(a["score"] - b["score"])] +
                      [abs(u - v) for u, v in zip(a["bbox"], b["bbox"])])
            max_err = max(max_err, err)
    if max_err > 1e-3:
        fail(f"entry serve: answers differ from compiled.detect by {max_err}")
    lat.sort()
    sums = {k: (sum(w for w, _ in v), sum(c for _, c in v), len(v))
            for k, v in split.items()}
    program_s = (sums["dispatch"][0] - sums["resize"][0] - sums["inputs"][0]) / 1e3
    out["serve"] = {"requests": 16, "dispatches": dispatches, "wall_s": wall,
                    "img_s": 16 / wall, "p50_ms": statistics.median(lat),
                    "p99_ms": lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)],
                    "max_err": max_err, "process_cpu_s": cpu,
                    "split_s": {k: {"wall": w / 1e3, "cpu": c / 1e3, "n": n}
                                for k, (w, c, n) in sums.items()},
                    "program_and_copy_s": program_s,
                    "batcher_busy": sums["dispatch"][0] / 1e3 / wall}
    log(f"entry serve split over the {wall:.2f} s window (wall / thread CPU, s; "
        f"summed over calls): " + ", ".join(
            f"{k} {w / 1e3:.3f} / {c / 1e3:.3f} ({n} calls)"
            for k, (w, c, n) in sums.items())
        + f"; the program and the copy back {program_s:.3f} (wall); the batcher "
          f"busy {out['serve']['batcher_busy']:.3f} of the window; the process used "
          f"{cpu:.2f} s of CPU ({cpu / wall:.2f} cores)")
    log(f"entry serve: 16 POSTs from 8 threads in {dispatches} device calls, "
        f"{16 / wall:.2f} img/s, latency p50 {out['serve']['p50_ms']:.1f} ms, p99 "
        f"{out['serve']['p99_ms']:.1f} ms; every answer equals compiled.detect "
        f"(max diff {max_err:.3g})")
    del compiled
    torch.cuda.empty_cache()

    # -- (g) eval on (b)'s labels against the seeded ground truth
    text, _, _, _ = run_cli("eval", "eval", "--gt-dir", gt_dir, "--result-dir", det_b,
                            "--class-names", "car")
    out["eval"] = json.loads(text.strip().splitlines()[-1])

    # -- (h) time: the flagship in deploy geometry, bf16, batch 4
    text, _, _, secs = run_cli("time", "time", "--zoo", "kitti_car/mscnn-8s-768-trainval",
                               "--deploy", "--bf16", "--max-out", 256, "--batch-size",
                               BATCH, "--iterations", 3)
    out["time"] = {k: float(m.group(1)) for k, m in (
        (k, re.search(rf"{re.escape(p)}: ([0-9.]+) ms", text)) for k, p in (
            ("forward_ms", "Average Forward pass"),
            ("fwd_bwd_update_ms", "Average Forward-Backward-Update"))) if m}
    torch.cuda.empty_cache()

    # -- (i) the KITTI cascade through compile --batch 1 and detect --compiled
    gen = torch.Generator().manual_seed(SEED + 34)
    ccfg32 = zoo.cascade_kitti_car_7s_576_2x(deploy=True)
    pc = nonzero_biases(CC.init_params(gen, ccfg32, device=dev), SEED + 35)
    csnap = CKPT.snapshot(os.path.join(root, "cascade"), {"params": pc, "solver": {
        "it": torch.tensor(0, dtype=torch.int32)}}, 0)
    art_c = os.path.join(root, "art_cascade")
    run_cli("compile cascade", "compile", "--zoo", "kitti_car/cascade-mscnn-7s-576-2x",
            "--weights", csnap, "--bf16", "--batch", 1, "-o", art_c)
    det_cc = os.path.join(root, "det_cascade")
    text, launches, sink, secs = run_cli(
        "detect compiled cascade", "detect", "--compiled", art_c, "--image-dir", img_dir,
        "--iterations", 2, "--output-dir", det_cc,
        expect={"nms": 4, "conv1_pool": 2, "int8_gemm": 0})
    held = hold_to_plain(sink, "entry cascade", out)
    del sink
    ccfg = dataclasses.replace(ccfg32, base=dataclasses.replace(
        ccfg32.base, compute_dtype="bfloat16", pallas_conv1=True))
    pcb = M.cast_params(pc, torch.bfloat16)
    cc = aot.load_deploy(art_c)
    differ = 0
    for i in range(2):
        want = I.detect_cascade(pcb, decoded[i], ccfg, spec)
        got = cc.detect(decoded[i])
        differ += same_outputs(f"entry cascade image {i}",
                               {k: torch.from_numpy(got[k]) for k in want},
                               {k: torch.from_numpy(v) for k, v in want.items()})
        ref_dir = os.path.join(root, "ref_cascade")
        I.write_kitti_labels(I.detections_to_kitti(want, names), ref_dir, i)
        if not differ and open(os.path.join(det_cc, f"{i:06d}.txt")).read() != \
                open(os.path.join(ref_dir, f"{i:06d}.txt")).read():
            fail(f"entry cascade: {i:06d}.txt differs from detect_cascade's labels")
    out["cascade"] = {"launches": launches, "differ": differ,
                      "kernel_ops": cc.meta["kernel_ops"]}
    log(f"entry cascade: compile --batch 1 + detect --compiled on 2 images, launches "
        f"{launches}; {held}; " + ("bit-equal to detect_cascade, labels equal"
                                   if not differ else f"{differ} values differ from "
                                   "detect_cascade (within 1e-4)"))
    del cc, pc, pcb, p32, params
    torch.cuda.empty_cache()

    # -- (j) nothing of jax, mscnn_tpu or cv2 was imported
    if jax_loaded() or any(m == "cv2" or m.startswith("cv2.") for m in sys.modules):
        fail("the deploy entry points imported jax, mscnn_tpu or cv2")
    out.update(root=root, snapshot=snap, art_bf16=arts["bf16"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"entry: no jax, mscnn_tpu or cv2 module loaded; phase 16 took "
        f"{out['seconds']:.1f} s")
    return out


# -- phase 17: JPEG without cv2, the training input path ------------------------

JPEG_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "assets", "jpeg")


def jpeg_input_path(dev, counts, zero_counts, PROF, rec, ep, tr):
    """Phase 17 (module notes): the committed JPEG / Adam7 fixtures through
    data/image_io.py, `detect` bf16 and int8 and `serve` on the eight
    375x1242 JPEGs (phase 16's snapshot and batch-4 artifact, ep), and
    `train2` from a record shard of them through the worker loader and the
    one-thread pipeline (phase 13's harness; tr: phase 13's figures).
    Returns the figures the kernels line and the log use."""
    import hashlib
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mscnn_torch import inference as I
    from mscnn_torch import serve as SV
    from mscnn_torch.data import image_io
    from mscnn_torch.data import records as R
    from mscnn_torch.data import window_file as W
    from mscnn_torch.data.resize import resize_bilinear_u8
    from mscnn_torch.io import aot
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo

    t_phase = time.perf_counter()
    out = {"launches": {}, "nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0,
           "int8_err": 0.0}
    run_cli = functools.partial(cli_run, out, rec, counts, zero_counts)
    root = tempfile.mkdtemp(prefix="mscnn_jpeg_")
    img_dir = os.path.join(JPEG_ASSETS, "kitti")
    n_img = 8

    # -- (a) every fixture decodes to cv2's decode, bit for bit (the manifest's
    # digest of cv2.imread's array; the small ones also their .want.png)
    with open(os.path.join(JPEG_ASSETS, "manifest.json")) as f:
        manifest = json.load(f)
    dec_ms = []
    for rel, e in sorted(manifest.items()):
        path = os.path.join(JPEG_ASSETS, rel)
        t0 = time.perf_counter()
        img = image_io.imread(path)
        ms = (time.perf_counter() - t0) * 1e3
        hw = image_io.shape(image_io.read_header_bytes(path))
        if list(img.shape) != e["shape"] or hw != tuple(e["shape"][:2]) or \
                hashlib.sha256(img.tobytes()).hexdigest() != e["sha256"]:
            fail(f"jpeg: {rel} ({e['mode']}) does not decode to cv2's array "
                 f"({img.shape}, header {hw})")
        if rel.startswith("kitti/"):
            dec_ms.append(ms)
        elif not np.array_equal(img, image_io.imread(path.rsplit(".", 1)[0] + ".want.png")):
            fail(f"jpeg: {rel} differs from its .want.png")
    out["decode_ms"] = statistics.median(dec_ms)
    log(f"jpeg: (a) all {len(manifest)} fixtures ({', '.join(sorted({e['mode'].split(',')[0] for e in manifest.values()}))} "
        f"modes) decode bit for bit to cv2's arrays, header shapes equal; JPEG "
        f"decode {out['decode_ms']:.1f} ms a 375x1242 image (median of {n_img}, "
        f"{min(dec_ms):.1f}-{max(dec_ms):.1f})")

    # -- (b) detect on the JPEGs at 768x2560: bf16 + conv1 auto (2 K1 + 1 K2 an
    # image), the labels equal detect_batch's on the decoded images; int8 +
    # heads on two of them (17 K4 an image, 15 a head-calibration image)
    snap = ep["snapshot"]
    det_b = os.path.join(root, "det_bf16")
    text, launches, sink, secs = run_cli(
        "jpeg detect bf16", "detect", "--zoo", FLAGSHIP_256, "--weights", snap, "--bf16",
        "--conv1", "auto", "--image-dir", img_dir, "--output-dir", det_b,
        expect={"nms": 2 * n_img, "conv1_pool": n_img, "int8_gemm": 0})
    held = hold_to_plain(sink, "jpeg detect bf16", out)
    del sink
    m = re.search(r"\(([0-9.]+) s/img steady-state", text)
    out["detect_s_img"] = float(m.group(1)) if m else None
    p32 = torch.load(os.path.join(snap, CKPT.STATE_FILE), map_location=dev,
                     weights_only=True)["params"]
    cfg = dataclasses.replace(zoo.get(FLAGSHIP_256, deploy=True),
                              compute_dtype="bfloat16", pallas_conv1=True)
    params = M.cast_params(p32, torch.bfloat16)
    del p32
    spec = I.DetectSpec()
    names = I.KITTI_CLASS_NAMES["kitti_car"]
    decoded = [image_io.imread(os.path.join(img_dir, f"{i:06d}.jpg"))
               for i in range(n_img)]
    ref_dir = os.path.join(root, "ref_bf16")
    for i, img in enumerate(decoded):
        I.write_kitti_labels(I.detections_to_kitti(
            I.detect_batch(params, [img], cfg, spec)[0], names), ref_dir, i)
        with open(os.path.join(det_b, f"{i:06d}.txt")) as a, \
                open(os.path.join(ref_dir, f"{i:06d}.txt")) as b:
            if a.read() != b.read():
                fail(f"jpeg detect bf16: {i:06d}.txt differs from detect_batch's labels")
    log(f"jpeg: (b) detect --bf16 --conv1 auto on {n_img} JPEGs: {secs:.2f} s, "
        f"launches {launches}; {held}; labels equal to detect_batch's on the "
        f"decoded images; steady {out['detect_s_img']} s/img")
    n8 = 2
    text, launches, sink, secs = run_cli(
        "jpeg detect int8", "detect", "--zoo", FLAGSHIP_256, "--weights", snap, "--bf16",
        "--int8", "--int8-heads", "--calib-images", n8, "--image-dir", img_dir,
        "--iterations", n8, "--output-dir", os.path.join(root, "det_int8"),
        expect={"int8_gemm": 17 * n8 + 15 * n8, "conv1_pool": 0,
                "nms": 2 * n8 + n8})   # + the head calibration's propose
    held = hold_to_plain(sink, "jpeg detect int8", out)
    del sink
    torch.cuda.empty_cache()
    log(f"jpeg: (b) detect --int8 --int8-heads, calibrated on {n8} JPEGs: {secs:.2f} s, "
        f"launches {launches} = 17 x {n8} + 15 x {n8} (head calibration); {held}")
    # the split of detect's time an image: decode, resize (host), batch-1 step
    rs = []
    for img in decoded:
        t0 = time.perf_counter()
        resize_bilinear_u8(img, (cfg.input_hw[1], cfg.input_hw[0]))
        rs.append((time.perf_counter() - t0) * 1e3)
    c = aot.load_deploy(ep["art_bf16"])
    one = [t[:1] for t in c.inputs([c._prep(im) for im in decoded[:BATCH]])]
    e2e1 = I.make_e2e_forward(params, cfg, spec)
    out["split_ms"] = {"decode": out["decode_ms"], "resize": statistics.median(rs),
                       "device": cuda_ms(lambda: e2e1(params, *one))}
    log(f"jpeg: (b) detect split, ms an image (medians): JPEG decode "
        f"{out['split_ms']['decode']:.2f}, resize to 768x2560 "
        f"{out['split_ms']['resize']:.2f}, the batch-1 bf16 step "
        f"{out['split_ms']['device']:.3f} (CUDA events)")
    del e2e1, one, params

    # -- (c) serve: one JPEG POST, the answer equal to compiled.detect
    boot, ready = {}, threading.Event()

    def started(httpd):
        boot["httpd"] = httpd
        ready.set()

    threading.Thread(target=SV.serve, args=(ep["art_bf16"], 0), kwargs={
        "started": started, "linger_ms": 5.0}, daemon=True).start()
    if not ready.wait(300):
        fail("jpeg serve: the server did not start")
    httpd = boot["httpd"]
    try:
        with open(os.path.join(img_dir, "000000.jpg"), "rb") as f:
            body = f.read()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/detect", data=body,
            method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            res = json.loads(r.read())
        out["serve_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
    want = SV.detections_json(c.detect(decoded[0]))
    err = 0.0
    if res["num"] != len(want) or [d["class_id"] for d in res["detections"]] != \
            [d["class_id"] for d in want]:
        fail(f"jpeg serve: {res['num']} detections, compiled.detect {len(want)}")
    for a, b in zip(res["detections"], want):
        err = max([err, abs(a["score"] - b["score"])] +
                  [abs(u - v) for u, v in zip(a["bbox"], b["bbox"])])
    if err > 1e-3:
        fail(f"jpeg serve: the answer differs from compiled.detect by {err}")
    log(f"jpeg: (c) serve: a JPEG POST answered in {out['serve_ms']:.1f} ms with "
        f"{res['num']} detections, equal to compiled.detect (max diff {err:.3g})")
    del c
    torch.cuda.empty_cache()

    # -- (d) train2 from a record shard of the JPEGs on phase 13's harness:
    # through the worker loader (the CLI's default, a worker a core; then 2
    # workers timed), then --no-native; the same batches and the same first
    # losses
    def write_data(r):
        # the shard through the tools entry point, as a user writes one
        import contextlib
        import io

        from mscnn_torch import cli

        wf, shard = os.path.join(img_dir, "trainval.txt"), os.path.join(r, "trainval.rec")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["convert_imageset", "--window-file", wf,
                           "--root-folder", img_dir + os.sep, "-o", shard])
        n = len(W.parse_window_file(wf, img_dir + os.sep))
        if rc != 0 or buf.getvalue() != f"Packed {n} records into {shard}\n" or \
                len(R.RecordShard(shard)) != n:
            fail(f"jpeg train: cli convert_imageset exited {rc}: {buf.getvalue()!r}")
        return shard

    nw = min(len(os.sched_getaffinity(0)), 3 * BATCH)    # the CLI's worker count
    runs = {}
    for label, more, extra_t in (
            ("worker loader", (), [("2 workers", {"num_workers": 2})]),
            ("--no-native", ("--no-native",), [])):
        runs[label] = training_entry_point(
            dev, counts, zero_counts, PROF, tag=f"jpeg train {label}",
            write_data=write_data, argv_extra=more, timed_extra=extra_t,
            timed_iters=20, full=False)
        out["launches"][f"train {label}"] = runs[label]["launches"]
        out["conv1_err"] = max(out["conv1_err"], runs[label]["k2_err"])
        out["conv1_share"] = min(out["conv1_share"], runs[label]["k2_share"])
    a, b = runs["worker loader"], runs["--no-native"]
    if a["batch_digests"] != b["batch_digests"] or len(a["batch_digests"]) != 8:
        fail(f"jpeg train: the worker loader's {len(a['batch_digests'])} batches differ "
             f"from the one-thread pipeline's")
    if not a["shown"] or a["shown"][0] != b["shown"][0]:
        fail(f"jpeg train: the first iteration's losses differ: {a['shown'][:1]} "
             f"against {b['shown'][:1]}")
    later = max((abs(x - y) / max(abs(y), 1e-12) for (_, ma), (_, mb) in
                 zip(a["shown"][1:], b["shown"][1:]) for k, x in ma.items()
                 for y in [mb[k]]), default=0.0)
    out["train"] = {
        "phase13": {"wait_ms": tr["wait_ms"], "wait_share": tr["wait_share"],
                    "iter_ms": tr["iter_ms"]},
        **{f"{k} {f'{nw} workers' if k == 'worker loader' else 'one thread'}":
           {"wait_ms": v["wait_ms"], "wait_share": v["wait_share"], "iter_ms": v["iter_ms"]}
           for k, v in runs.items()},
        **{f"worker loader {k}": v for k, v in a["timed"].items()}}
    log(f"jpeg: (d) train2 from a JPEG record shard: the worker loader's 8 batches "
        f"equal the one-thread pipeline's (digests), the first iteration's losses "
        f"equal (loss {a['shown'][0][1]['loss']:.6f}, {len(a['shown'][0][1])} display "
        f"metrics); "
        f"later displays within {later:.3g} (relative)")
    for k, v in out["train"].items():
        log(f"jpeg: (d) input wait, {k}: {v['wait_ms']:.2f} ms a step, "
            f"{v['wait_share']:.4f} of the iteration ({v['iter_ms']:.2f} ms)"
            + (f"; workers' decode {1e3 * v['stats']['decode_s'] / v['stats']['images']:.1f}"
               f" ms, render {1e3 * v['stats']['render_s'] / v['stats']['images']:.1f} ms "
               f"an image" if v.get("stats") and v["stats"]["images"] else ""))

    # -- (e) nothing of jax, mscnn_tpu or cv2 was imported
    if jax_loaded() or any(m == "cv2" or m.startswith("cv2.") for m in sys.modules):
        fail("phase 17 imported jax, mscnn_tpu or cv2")
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"jpeg: (e) no jax, mscnn_tpu or cv2 module loaded; phase 17 took "
        f"{out['seconds']:.1f} s")
    return out

# -- phase 18: the generic prototxt nets ---------------------------------------

VGG16_CONVS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
               (512, 512, 512))     # VGG_ILSVRC_16_layers_deploy.prototxt


def vgg16_deploy_prototxt(batch=10):
    """The Caffe Model Zoo's VGG_ILSVRC_16_layers_deploy.prototxt (Simonyan
    & Zisserman): 13 3x3 convs (pad 1) with ReLUs in 5 blocks, each ending in
    a 2x2 / 2 max pool, fc6 / fc7 4096 with ReLU and dropout 0.5, fc8 1000,
    softmax; input [batch, 3, 224, 224]. No weights are published with it
    here: gaussian fillers with He's std sqrt(2 / fan_in), so that the
    activations neither vanish nor blow up, and 0.01-std biases."""
    def gauss(fan_in):
        return (f'weight_filler {{ type: "gaussian" std: {math.sqrt(2.0 / fan_in):.6g} }} '
                'bias_filler { type: "gaussian" std: 0.01 }')
    out = ['name: "VGG_ILSVRC_16_layers"',
           f'layer {{ name: "data" type: "Input" top: "data" input_param {{ '
           f'shape {{ dim: {batch} dim: 3 dim: 224 dim: 224 }} }} }}']
    bottom, cin = "data", 3
    for b, block in enumerate(VGG16_CONVS, 1):
        for i, cout in enumerate(block, 1):
            name = f"conv{b}_{i}"
            out.append(f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
                       f'top: "{name}" convolution_param {{ num_output: {cout} pad: 1 '
                       f'kernel_size: 3 {gauss(9 * cin)} }} }}')
            out.append(f'layer {{ name: "relu{b}_{i}" type: "ReLU" bottom: "{name}" '
                       f'top: "{name}" }}')
            bottom, cin = name, cout
        out.append(f'layer {{ name: "pool{b}" type: "Pooling" bottom: "{bottom}" '
                   f'top: "pool{b}" pooling_param {{ pool: MAX kernel_size: 2 '
                   'stride: 2 } }')
        bottom = f"pool{b}"
    fan = 7 * 7 * 512
    for name, n in (("fc6", 4096), ("fc7", 4096), ("fc8", 1000)):
        out.append(f'layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" '
                   f'top: "{name}" inner_product_param {{ num_output: {n} '
                   f'{gauss(fan)} }} }}')
        bottom, fan = name, n
        if name != "fc8":
            k = name[2:]
            out.append(f'layer {{ name: "relu{k}" type: "ReLU" bottom: "{name}" '
                       f'top: "{name}" }}')
            out.append(f'layer {{ name: "drop{k}" type: "Dropout" bottom: "{name}" '
                       f'top: "{name}" dropout_param {{ dropout_ratio: 0.5 }} }}')
    out.append('layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }')
    return "\n".join(out) + "\n"


def write_digits(root, n, seed):
    """n seeded 28x28 8-bit PGM "digits" under root and an ImageData list:
    class c is a fixed random stroke pattern of its own, shifted by up to 2
    pixels and noised, so the 10 classes are learnable."""
    import numpy as np

    rng = np.random.RandomState(seed)
    templates = (rng.rand(10, 28, 28) < 0.18).astype(np.float32)
    templates[:, :4] = templates[:, -4:] = 0
    templates[:, :, :4] = templates[:, :, -4:] = 0
    lines = []
    for i in range(n):
        c = i % 10
        img = np.roll(templates[c], rng.randint(-2, 3, 2), (0, 1)) * 200.0
        img = np.clip(img + rng.rand(28, 28) * 55.0, 0, 255).astype(np.uint8)
        path = os.path.join(root, f"d{i:05d}.pgm")
        with open(path, "wb") as f:
            f.write(b"P5\n28 28\n255\n" + img.tobytes())
        lines.append(f"{path} {c}\n")
    return lines


def lenet_on_image_data(root, train_list, test_list):
    """examples/mnist/lenet.prototxt with its two HDF5Data layers (h5py is
    not on the card's machine) as ImageData over the PGM lists, scaled by
    1/256 as the reference's lenet_train_test.prototxt scales its input.
    ImageData reads in colour (cv2.imread's IMREAD_COLOR in the JAX
    sources): the gray digits arrive as 3 equal channels."""
    from mscnn_torch.config import prototxt as PB

    net = PB.parse_prototxt_file("examples/mnist/lenet.prototxt")
    for layer in PB.layers(net):
        if layer["type"] == "HDF5Data":
            test = PB.layer_phase(layer) == "TEST"
            p = layer.pop("hdf5_data_param")
            layer["type"] = "ImageData"
            layer["image_data_param"] = {
                "source": test_list if test else train_list,
                "batch_size": int(p["batch_size"]), "shuffle": not test}
            layer["transform_param"] = {"scale": 0.00390625}
    path = os.path.join(root, "lenet.prototxt")
    with open(path, "w") as f:
        f.write(PB.emit_prototxt(net))
    return path


def generic_nets(dev, counts, zero_counts):
    """Phase 18 (module notes): LeNet through `cli train` / `test`, VGG16's
    deploy net through classify.Classifier, and `cli time --layers` on it.
    No TPU kernel lies on this path: the phase checks that none of K1-K4
    launched. Returns its figures."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mscnn_torch import classify as CL
    from mscnn_torch import cli
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.io import bridge
    from mscnn_torch.train import generic as G
    from mscnn_torch.train import solver as S

    t_phase = time.perf_counter()
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_generic_")
    zero_counts()
    try:
        # -- (a) LeNet: cli train (300 iterations, one snapshot), cli test --
        lines = write_digits(root, 1280, SEED + 18)
        train_list, test_list = (os.path.join(root, n) for n in ("train.txt", "test.txt"))
        with open(train_list, "w") as f:
            f.writelines(lines[:1024])
        with open(test_list, "w") as f:
            f.writelines(lines[1024:])
        net_path = lenet_on_image_data(root, train_list, test_list)
        fields = PB.parse_prototxt_file("examples/mnist/lenet_solver.prototxt")
        iters = 200
        fields.update(net=net_path, max_iter=iters, snapshot=iters, display=25,
                      snapshot_prefix=os.path.join(root, "lenet"))
        solver = os.path.join(root, "lenet_solver.prototxt")
        with open(solver, "w") as f:
            f.write(PB.emit_prototxt(fields))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train", "--solver", solver])
        train_s = time.perf_counter() - t0
        losses = [float(x) for x in re.findall(r"loss = ([-+0-9.e]+)", buf.getvalue())]
        snap = os.path.join(root, f"lenet_iter_{iters}")
        if rc != 0 or len(losses) != iters // 25 or not os.path.isdir(snap):
            fail(f"generic: cli train exited {rc} with losses {losses}")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < 0.5 * losses[0]:
            fail(f"generic: LeNet's loss did not fall: {losses}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["test", "--solver", solver, "--weights", snap,
                           "--iterations", "4"])
        test = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or not all(math.isfinite(v) for v in test.values()):
            fail(f"generic: cli test exited {rc}: {test}")
        log(f"generic (a): LeNet cli train {iters} iterations in {train_s:.1f} s, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; cli test {test}")

        # one generic step on the card equals the same step on the CPU (TF32
        # off): the same seed, params and batch (LeNet draws nothing)
        sspec = S.spec_from_prototxt_fields(fields)
        runs = []
        for d in (dev, torch.device("cpu")):
            state, step, source, net = G.setup(net_path, sspec, seed=3, device=d)
            batch = source()
            state, m = step(state, batch)
            runs.append((bridge.to_jax_net_params(state["params"],
                                                  net.param_layouts()),
                         float(m["loss"]), batch))
        (gp, gl, gb), (cp, cl_, cb) = runs
        if not all(torch.equal(gb[k].cpu(), cb[k]) for k in cb):
            fail("generic: the card's and the CPU's first batches differ")
        step_err = max(float(np.abs(gp[n][k] - cp[n][k]).max()) for n in cp for k in cp[n])
        if not math.isclose(gl, cl_, rel_tol=1e-4, abs_tol=1e-5) or not all(
                np.allclose(gp[n][k], cp[n][k], rtol=1e-4, atol=1e-5)
                for n in cp for k in cp[n]):
            fail(f"generic: one LeNet step on the card differs from the CPU's: "
                 f"loss {gl} vs {cl_}, params max err {step_err:.3g}")
        # the step's time with the batches on the card, and the host batch
        state, step, source, net = G.setup(net_path, sspec, seed=3, device=dev)
        t0 = time.perf_counter()
        batches = [source() for _ in range(20)]
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) / 20 * 1e3
        for b in batches[:5]:
            state, m = step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            state, m = step(state, batches[i % 20])
        torch.cuda.synchronize()
        out["lenet"] = {"iter_ms": (time.perf_counter() - t0) / 50 * 1e3,
                        "host_batch_ms": batch_ms,
                        "cli_iter_ms": train_s / iters * 1e3,
                        "loss": [losses[0], losses[-1]], "test": test,
                        "card_vs_cpu_loss": [gl, cl_], "card_vs_cpu_max_err": step_err}
        log(f"generic (a): LeNet step {out['lenet']['iter_ms']:.3f} ms on the card "
            f"(batch on the card), host batch {batch_ms:.2f} ms, cli "
            f"{out['lenet']['cli_iter_ms']:.2f} ms an iteration; one step card vs "
            f"CPU: loss {gl:.7g} / {cl_:.7g}, params max err {step_err:.3g}")

        # -- (b) VGG16 deploy, 10 oversampled crops, through Classifier ----------
        vgg = os.path.join(root, "vgg16_deploy.prototxt")
        with open(vgg, "w") as f:
            f.write(vgg16_deploy_prototxt())
        mean = np.array([103.939, 116.779, 123.68], np.float32)
        img = np.random.RandomState(SEED + 19).rand(300, 400, 3).astype(np.float32) * 255
        # the 0.017 input scale of Caffe's ImageNet MobileNet prototxts keeps
        # the random net's logits O(1), so the softmax does not saturate
        kw = dict(image_dims=(256, 256), mean=mean, input_scale=0.017, seed=1)
        t0 = time.perf_counter()
        clf = CL.Classifier(vgg, device=dev, **kw)
        build_s = time.perf_counter() - t0
        p_card = clf.predict([img])
        t0 = time.perf_counter()
        for _ in range(5):
            p_card = clf.predict([img])
        predict_ms = (time.perf_counter() - t0) / 5 * 1e3
        crops = np.stack([clf.transformer.preprocess(clf.input_name, c)
                          for c in CL.oversample([CL.resize_image(img, (256, 256))],
                                                 (224, 224))])
        x = torch.from_numpy(crops).to(dev)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: clf.net.apply(clf.params, {"data": x})["prob"],
                             iters=10, warmup=3)
        cpu = CL.Classifier(vgg, device="cpu", **kw)
        p_cpu = cpu.predict([img])
        vgg_err = float(np.abs(p_card - p_cpu).max())
        if p_card.shape != (1, clf.net.shapes["prob"][-1]) or \
                not np.isfinite(p_card).all() or \
                int(p_card.argmax()) != int(p_cpu.argmax()) or \
                not np.allclose(p_card, p_cpu, rtol=1e-3, atol=1e-6):
            fail(f"generic: VGG16 10-crop probabilities on the card differ from "
                 f"the CPU's: argmax {int(p_card.argmax())} vs {int(p_cpu.argmax())}, "
                 f"max err {vgg_err:.3g}")
        del cpu
        out["vgg16"] = {"forward_ms": fwd_ms, "predict_ms": predict_ms,
                        "build_s": build_s, "max_abs_err": vgg_err,
                        "top_prob": float(p_card.max()),
                        "flops": 10 * 2 * 15.47e9}
        log(f"generic (b): VGG16 10x224x224 forward {fwd_ms:.3f} ms on the card "
            f"(Classifier.predict of one image {predict_ms:.1f} ms, build "
            f"{build_s:.1f} s); argmax {int(p_card.argmax())} = the CPU's, probs "
            f"max err {vgg_err:.3g} (top {float(p_card.max()):.5f})")
        del clf, x

        # -- (c) cli time --layers on VGG16's deploy net ------------------------
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["time", "--layers", "--model", vgg, "--iterations", "5"])
        table = buf.getvalue().strip().splitlines()
        rows = [ln.split() for ln in table[1:-1]]
        n_rows = len(PB.layers(PB.parse_prototxt_file(vgg))) - 1   # not Input
        if rc != 0 or len(rows) != n_rows or not all(
                math.isfinite(float(r[2])) for r in rows):
            fail(f"generic: time --layers exited {rc} with {len(rows)} rows")
        for ln in table:
            log(f"generic (c): {ln}")
        top = sorted(rows, key=lambda r: -float(r[2]))[:5]
        out["layers_top5"] = [(r[0], float(r[2]), float(r[3])) for r in top]
        out["layers_total"] = [float(v) for v in table[-1].split()[-2:]]

        # -- (d) no kernel and no jax, mscnn_tpu, cv2 or h5py --------------------
        out["launches"] = counts()
        if any(out["launches"].values()):
            fail(f"generic: a TPU-kernel port launched on a path without one: "
                 f"{out['launches']}")
        loaded = [m for m in sys.modules if m.split(".")[0] in
                  ("jax", "mscnn_tpu", "cv2", "h5py")]
        if loaded:
            fail(f"generic: {sorted(loaded)[:5]} imported")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"generic (d): no K1-K4 launch, no jax, mscnn_tpu, cv2 or h5py module; "
        f"phase 18 took {out['seconds']:.1f} s")
    return out


# -- phase 19: Caffe databases -------------------------------------------------

DIGITS = 10000      # MNIST's test-set count, at its 28x28 size


def lenet_on_data(root, train_db, test_db):
    """examples/mnist/lenet.prototxt with its two HDF5Data layers as the
    `Data` layers of the reference's lenet_train_test.prototxt (scale
    1/256): TRAIN reads the LMDB, TEST the LevelDB."""
    from mscnn_torch.config import prototxt as PB

    net = PB.parse_prototxt_file("examples/mnist/lenet.prototxt")
    for layer in PB.layers(net):
        if layer["type"] == "HDF5Data":
            test = PB.layer_phase(layer) == "TEST"
            p = layer.pop("hdf5_data_param")
            layer["type"] = "Data"
            layer["data_param"] = {"source": test_db if test else train_db,
                                   "backend": "LEVELDB" if test else "LMDB",
                                   "batch_size": int(p["batch_size"])}
            layer["transform_param"] = {"scale": 0.00390625}
    path = os.path.join(root, "lenet_data.prototxt")
    with open(path, "w") as f:
        f.write(PB.emit_prototxt(net))
    return path


def caffe_databases(dev, counts, zero_counts, gn):
    """Phase 19 (module notes): convert_imageset to an LMDB and a LevelDB,
    the three sources' batches, compute_mean, LeNet through `cli train` /
    `test` on `Data` layers, and snapshot_format HDF5. No TPU kernel lies
    on this path. gn: phase 18's figures. Returns the phase's figures."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from mscnn_torch import cli
    from mscnn_torch import tools as TL
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.data import sources as SRC
    from mscnn_torch.io import caffemodel as CM
    from mscnn_torch.io import leveldb as LDB
    from mscnn_torch.io import lmdb as L
    from mscnn_torch.train import generic as G
    from mscnn_torch.train import solver as S

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        return rc, buf.getvalue(), time.perf_counter() - t0

    t_phase = time.perf_counter()
    out = {"db": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_caffe_db_")
    zero_counts()
    try:
        # -- (a) 10,000 digits to an LMDB and a LevelDB ------------------------
        lines = write_digits(root, DIGITS, SEED + 20)
        lst = os.path.join(root, "digits.txt")
        with open(lst, "w") as f:
            f.writelines(lines)
        dbs = {}
        for backend, reader in (("lmdb", L.LMDBReader), ("leveldb", LDB.LevelDBReader)):
            dbs[backend] = os.path.join(root, f"digits_{backend}")
            rc, said, write_s = run("convert_imageset", "--listfile", lst,
                                    "--backend", backend, "-o", dbs[backend])
            if rc != 0 or said != f"Packed {DIGITS} records into {dbs[backend]}\n":
                fail(f"databases: convert_imageset --backend {backend} exited {rc}: "
                     f"{said!r}")
            nbytes = sum(os.path.getsize(os.path.join(dbs[backend], n))
                         for n in os.listdir(dbs[backend]))
            t0 = time.perf_counter()
            with reader(dbs[backend]) as db:
                items = list(db.items())
                pixels = [L.decode_datum(v).array() for _, v in items]
            read_s = time.perf_counter() - t0
            if len(items) != DIGITS or any(p.shape != (3, 28, 28) for p in pixels):
                fail(f"databases: the {backend} holds {len(items)} records")
            out["db"][backend] = {"write_rec_s": DIGITS / write_s, "bytes": nbytes,
                                  "read_rec_s": DIGITS / read_s, "items": items}
            if backend == "leveldb":
                # the table's checksums: numpy lanes (io/leveldb.py) against the
                # JAX module's byte loop, on the records' values
                values = [v for _, v in items]
                t0 = time.perf_counter()
                lanes = LDB._crc32c_many(values)
                lanes_s = time.perf_counter() - t0
                table = [int(t) for t in LDB._CRC_TABLE]
                t0 = time.perf_counter()
                for v, want in zip(values[:1000], lanes):
                    crc = 0xFFFFFFFF
                    for x in v:
                        crc = (crc >> 8) ^ table[(crc ^ x) & 0xFF]
                    if crc ^ 0xFFFFFFFF != want:
                        fail("databases: the numpy crc32c differs from the byte loop")
                loop_s = time.perf_counter() - t0
                mb = sum(map(len, values)) / 1e6
                out["crc32c_mb_s"] = {"lanes": mb / lanes_s,
                                      "byte_loop": sum(map(len, values[:1000])) / 1e6 / loop_s}
                log(f"databases (a): crc32c of the {DIGITS} values ({mb:.1f} MB): numpy "
                    f"lanes {out['crc32c_mb_s']['lanes']:.1f} MB/s, the byte loop (first "
                    f"1,000) {out['crc32c_mb_s']['byte_loop']:.2f} MB/s")
            log(f"databases (a): {backend}: {DIGITS} records written in "
                f"{write_s:.2f} s ({DIGITS / write_s:.0f} records/s), {nbytes} bytes on "
                f"disk; read and decoded in {read_s:.3f} s ({DIGITS / read_s:.0f} "
                f"records/s)")
        if out["db"]["lmdb"].pop("items") != out["db"]["leveldb"].pop("items"):
            fail("databases: the LMDB's and the LevelDB's records differ")

        # -- (b) the three sources, bit for bit --------------------------------
        tspec = SRC.TransformSpec(scale=0.00390625, mean_values=(33.0, 33.0, 33.0),
                                  crop_size=24, mirror=True)
        srcs = (SRC.LMDBDataset(dbs["lmdb"], 64, tspec, seed=SEED),
                SRC.LevelDBDataset(dbs["leveldb"], 64, tspec, seed=SEED),
                SRC.ImageListDataset(lst, 64, tspec, shuffle=False, seed=SEED))
        for i in range(3):
            (a, b, c) = (s.next_batch() for s in srcs)
            if not (np.array_equal(a["data"], b["data"]) and
                    np.array_equal(a["data"], c["image"]) and
                    np.array_equal(a["label"], b["label"]) and
                    np.array_equal(a["label"], c["label"])):
                fail(f"databases: batch {i} of the LMDB, LevelDB and ImageData "
                     f"sources differ")
        for s in srcs[:2]:
            s.close()
        log("databases (b): LMDB, LevelDB and ImageData batches bit-equal (3 x 64, "
            "crop 24, mirror, mean, scale)")

        # -- (c) compute_mean against numpy ----------------------------------
        mean_path = os.path.join(root, "mean.binaryproto")
        rc, said, _ = run("compute_mean", lst, "-o", mean_path)
        digits = np.stack([np.fromfile(ln.split()[0], np.uint8)[-784:].reshape(28, 28)
                           for ln in lines])
        m = float(np.sum(digits, dtype=np.uint64)) / digits.size
        with open(mean_path, "rb") as f:
            blob = CM.blobproto_to_array(f.read())
        want_blob = np.repeat((digits.sum(0, dtype=np.float64) / DIGITS)
                              .astype(np.float32)[None, None], 3, 1)
        bgr, _ = TL.compute_image_mean(lst)
        if rc != 0 or said != (f"mean_value (BGR): {m:.4f} {m:.4f} {m:.4f}\nWrote "
                               f"per-pixel mean BlobProto to {mean_path}\n") or \
                list(bgr) != [m] * 3 or not np.array_equal(blob, want_blob):
            fail(f"databases: compute_mean exited {rc}: {said!r}, triple {list(bgr)} "
                 f"against {m}, blob {blob.shape}")
        log(f"databases (c): compute_mean {said.splitlines()[0]!r} = the numpy mean "
            f"{m:.6f}; the per-pixel BlobProto {list(blob.shape)} equal")

        # -- (d) LeNet on Data layers: cli train, cli test --------------------
        net_path = lenet_on_data(root, dbs["lmdb"], dbs["leveldb"])
        fields = PB.parse_prototxt_file("examples/mnist/lenet_solver.prototxt")
        iters = 200
        fields.update(net=net_path, max_iter=iters, snapshot=iters, display=25,
                      snapshot_prefix=os.path.join(root, "lenet"))
        solver = os.path.join(root, "lenet_solver.prototxt")
        with open(solver, "w") as f:
            f.write(PB.emit_prototxt(fields))
        rc, said, train_s = run("train", "--solver", solver)
        losses = [float(x) for x in re.findall(r"loss = ([-+0-9.e]+)", said)]
        snap = os.path.join(root, f"lenet_iter_{iters}")
        if rc != 0 or len(losses) != iters // 25 or not os.path.isdir(snap):
            fail(f"databases: cli train exited {rc} with losses {losses}")
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < 0.5 * losses[0]:
            fail(f"databases: LeNet's loss did not fall: {losses}")
        rc, said, _ = run("test", "--solver", solver, "--weights", snap,
                          "--iterations", "4")
        test = json.loads(said.strip().splitlines()[-1])
        if rc != 0 or not all(math.isfinite(v) for v in test.values()):
            fail(f"databases: cli test exited {rc}: {test}")
        state, step, source, _ = G.setup(net_path, S.spec_from_prototxt_fields(fields),
                                         seed=3, device=dev)
        t0 = time.perf_counter()
        batches = [source() for _ in range(20)]
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) / 20 * 1e3
        for b in batches[:5]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            state, _ = step(state, batches[i % 20])
        torch.cuda.synchronize()
        g18 = gn["lenet"]
        out["lenet"] = {"iter_ms": (time.perf_counter() - t0) / 50 * 1e3,
                        "host_batch_ms": batch_ms, "cli_iter_ms": train_s / iters * 1e3,
                        "loss": [losses[0], losses[-1]], "test": test}
        log(f"databases (d): LeNet on Data layers: cli train {iters} iterations in "
            f"{train_s:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; cli test {test}")
        log(f"databases (d): step {out['lenet']['iter_ms']:.3f} ms (ImageData, phase 18: "
            f"{g18['iter_ms']:.3f}), host batch {batch_ms:.2f} ms ({g18['host_batch_ms']:.2f}), "
            f"cli {out['lenet']['cli_iter_ms']:.2f} ms an iteration "
            f"({g18['cli_iter_ms']:.2f})")

        # -- (e) snapshot_format: HDF5 -----------------------------------------
        h5_solver = os.path.join(root, "h5_solver.prototxt")
        with open(h5_solver, "w") as f:
            f.write(PB.emit_prototxt(dict(fields, max_iter=2, snapshot=2, display=0,
                                          test_interval=0, snapshot_format="HDF5",
                                          snapshot_prefix=os.path.join(root, "h5"))))
        has_h5py = importlib.util.find_spec("h5py") is not None
        try:
            rc, said, _ = run("train", "--solver", h5_solver)
            raised = None
        except ImportError as e:
            raised = str(e)
        wrote = os.path.exists(os.path.join(root, "h5_iter_2.caffemodel.h5"))
        if has_h5py and (raised is not None or rc != 0 or not wrote):
            fail(f"databases: an HDF5 snapshot with h5py installed: {raised or rc}")
        if not has_h5py and (raised is None or "h5py" not in raised):
            fail(f"databases: snapshot_format HDF5 without h5py did not raise the "
                 f"ImportError naming h5py (raised {raised!r})")
        out["hdf5"] = "wrote the .h5 pair" if has_h5py else f"ImportError: {raised}"
        log(f"databases (e): snapshot_format HDF5 -> {out['hdf5']}")

        # -- (f) no kernel, no jax, mscnn_tpu or cv2 ---------------------------
        out["launches"] = counts()
        if any(out["launches"].values()):
            fail(f"databases: a TPU-kernel port launched on a path without one: "
                 f"{out['launches']}")
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "mscnn_tpu", "cv2")]
        if loaded:
            fail(f"databases: {sorted(loaded)[:5]} imported")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"databases (f): no K1-K4 launch, no jax, mscnn_tpu or cv2 module; "
        f"phase 19 took {out['seconds']:.1f} s")
    return out


# -- phase 20: the tools: JPEG encoding, resize, extract_features, prototxt tools

TOOLS_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                            "assets")
FLAGSHIP = "kitti_car/mscnn-8s-768-trainval"
TOOLS_TOL = 1e-5    # extract_features' card-vs-CPU gate: rtol, atol * max|ref|


def load_fixture_module(rel, name):
    """A jax-free helper module of tests/assets, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS_ASSETS, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tools(dev, counts, zero_counts, decode_ms=None):
    """Phase 20 (module notes): the JPEG encoder against cv2's bytes, the
    tools commands against the JAX CLI's outputs (the manifests), the
    flagship's extract_features forward, and the card against the CPU on
    the tiny config. No TPU kernel lies on this path. decode_ms: phase
    17's JPEG decode ms, logged beside. Returns the phase's figures."""
    import contextlib
    import hashlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from mscnn_torch import cli
    from mscnn_torch import tools as TL
    from mscnn_torch.data import image_io
    from mscnn_torch.data import jpeg
    from mscnn_torch.data import jpeg_encode as JE
    from mscnn_torch.data import records as R
    from mscnn_torch.io import leveldb as LDB
    from mscnn_torch.io import lmdb as L
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    t_phase = time.perf_counter()
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    kitti = os.path.join(TOOLS_ASSETS, "jpeg", "kitti")
    scenes = sorted(n for n in os.listdir(kitti) if n.endswith(".jpg"))
    zero_counts()
    try:
        # -- (a) the encoder: cv2's bytes, and their decode --------------------
        with open(os.path.join(TOOLS_ASSETS, "jpeg_encode", "manifest.json")) as f:
            jm = json.load(f)
        n_enc = 0
        for name, by_q in sorted(jm["sources"].items()):
            with open(os.path.join(TOOLS_ASSETS, "jpeg_encode", name), "rb") as f:
                src = image_io.imdecode(f.read(), name, unchanged=True)
            for q, want in by_q.items():
                enc = JE.encode(src, int(q))
                dec = jpeg.decode(enc, name, unchanged=True)
                if (sha(enc), len(enc)) != (want["sha256"], want["len"]) or \
                        sha(dec.tobytes()) != want["decode_sha256"]:
                    fail(f"tools: {name} at quality {q} is not cv2's JPEG "
                         f"({len(enc)} bytes against {want['len']})")
                n_enc += 1
        enc_ms, dec_ms, read_ms = [], [], []
        decoded = {}
        for name in scenes:
            t0 = time.perf_counter()
            img = image_io.imread(os.path.join(kitti, name))
            read_ms.append((time.perf_counter() - t0) * 1e3)
            decoded[name] = img
            for q, want in sorted(jm["kitti"][name].items()):
                t0 = time.perf_counter()
                enc = JE.encode(img, int(q))
                enc_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                dec = jpeg.decode(enc, name, unchanged=True)
                dec_ms.append((time.perf_counter() - t0) * 1e3)
                if sha(enc) != want["sha256"] or sha(dec.tobytes()) != want["decode_sha256"]:
                    fail(f"tools: kitti {name} at quality {q} is not cv2's JPEG")
        mb = decoded[scenes[0]].nbytes / 1e6
        out["encode_ms"] = statistics.median(enc_ms)
        out["encode_mb_s"] = mb / out["encode_ms"] * 1e3
        out["decode_ms"] = statistics.median(dec_ms)
        out["read_ms"] = statistics.median(read_ms)
        log(f"tools (a): {n_enc} fixture encodes (colour and gray, 1x1-37x29, "
            f"quality 1-100) and {len(enc_ms)} of the 375x1242 scenes (q90, q95) "
            f"are cv2's bytes (SHA-256) and decode to cv2's arrays; a scene "
            f"encodes in {out['encode_ms']:.1f} ms (median, {min(enc_ms):.1f}-"
            f"{max(enc_ms):.1f}; {out['encode_mb_s']:.1f} MB/s of BGR pixels), "
            f"decodes in {out['decode_ms']:.1f} ms (imread {out['read_ms']:.1f}"
            + (f"; phase 17: {decode_ms:.1f}" if decode_ms is not None else "") + ")")

        # -- (b), (c), (e) the tools commands against the JAX CLI's outputs ---
        mf = load_fixture_module(os.path.join("tools_ref", "make_fixtures.py"),
                                 "tools_ref_fixtures")
        with open(os.path.join(TOOLS_ASSETS, "tools_ref", "manifest.json")) as f:
            tm = json.load(f)
        case_s = {}
        t_cases = time.perf_counter()
        mf.write_vbbs(os.path.join(root, "vbb"))
        for name, argv, outputs in mf.cases():
            t0 = time.perf_counter()
            got = mf.run_case(cli.main, root, argv, outputs)
            case_s[name] = time.perf_counter() - t0
            if got != tm[name]:
                fail(f"tools: `cli {' '.join(argv[:1])}` ({name}) differs from the JAX "
                     f"CLI's: {got['rc']}, {got['stdout'][:200]!r}, "
                     f"{len(got['files'])} files against {len(tm[name]['files'])}")
        out["cases_s"] = time.perf_counter() - t_cases
        log(f"tools (b): resize_images with the crop (500x300) and without "
            f"(640x192) over the 8 scenes: every file and line equal to the JAX "
            f"CLI's ({case_s['resize_crop']:.2f} / {case_s['resize_nocrop']:.2f} s)")
        # the databases read back through the port's readers: each record holds
        # the scene's JPEG, cv2's bytes at the case's quality
        shard = R.RecordShard(os.path.join(root, "kitti_jpg.rec"))
        rec = [shard.read_bytes(i) for i in range(len(shard))]
        ok = [im.shape == (375, 1242, 3) for im in map(shard.read_image, range(len(shard)))]
        shard.close()
        with LDB.LevelDBReader(os.path.join(root, "kitti_leveldb")) as db:
            ldb = [L.decode_datum(v) for _, v in db.items()]
        with L.LMDBReader(os.path.join(root, "kitti_lmdb")) as db:
            lmdb = [L.decode_datum(v) for _, v in db.items()]
        want95 = [jm["kitti"][n]["95"]["sha256"] for n in scenes]
        want90 = [jm["kitti"][n]["90"]["sha256"] for n in scenes]
        if [sha(b) for b in rec] != want95 or not all(ok) or \
                [sha(d.data) for d in lmdb] != want95 or \
                [sha(d.data) for d in ldb] != want90 or \
                not all(d.encoded and d.array().shape == (3, 375, 1242) for d in lmdb + ldb):
            fail("tools: the JPEG records, LMDB or LevelDB do not read back as the "
                 "scenes' JPEGs")
        log(f"tools (c): convert_imageset --encode .jpg of the kitti window file to "
            f"records, an LMDB (q95) and a LevelDB (q90): files equal to the JAX CLI's "
            f"({case_s['convert_records']:.2f} / {case_s['convert_lmdb']:.2f} / "
            f"{case_s['convert_leveldb']:.2f} s); read back through the port's "
            f"readers, each record is the scene's JPEG (the encoder manifest's "
            f"SHA-256) and decodes to 375x1242")
        log("tools (e): summary on the card (the V0 net, LeNet TEST), draw, "
            "upgrade_net_proto (V0, V1), upgrade_solver_proto, vbb2bbgt (a tree of "
            "two seeded .vbb, a stride): printed lines and files equal to the JAX "
            f"CLI's ({sum(v for k, v in case_s.items() if not k.startswith(('resize', 'convert'))):.2f} s)")
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        log_path = os.path.join(root, "train.log")
        mf.write_log(log_path)
        png = os.path.join(root, "curves.png")
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["plot_log", "--log", log_path, "--out", png])
            raised = None
        except ImportError as e:
            raised = str(e)
        if has_mpl and (raised or rc != 0 or image_io.imread(png).ndim != 3):
            fail(f"tools: plot_log with matplotlib installed: {raised or rc}")
        if not has_mpl and (raised is None or "matplotlib" not in raised):
            fail(f"tools: plot_log without matplotlib did not raise the ImportError "
                 f"naming it ({raised!r})")
        out["plot_log"] = "wrote the PNG" if has_mpl else f"ImportError: {raised}"
        log(f"tools (e): plot_log -> {out['plot_log']}")

        # -- (d) extract_features' forward on the flagship at full width -------
        cfg = zoo.get(FLAGSHIP, deploy=True)
        blobs = ["conv4_3", "conv5_3"] + [br.name for br in cfg.branches]
        params = M.init_params(torch.Generator().manual_seed(SEED + 30), cfg, device=dev)
        fwd = TL.feature_forward(params, cfg, blobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split = {"decode": [], "resize": [], "forward": []}
        shapes = None
        for i, name in enumerate(scenes):
            t0 = time.perf_counter()
            img = image_io.imread(os.path.join(kitti, name))
            t1 = time.perf_counter()
            x = TL.feature_input(img, cfg)
            t2 = time.perf_counter()
            feats = fwd(torch.from_numpy(x)[None].to(dev))
            host = {k: v[0].float().cpu().numpy() for k, v in feats.items()}
            t3 = time.perf_counter()
            if i:          # the first image warms cuDNN up
                for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                    split[k].append(dt * 1e3)
            if not all(np.isfinite(v).all() for v in host.values()):
                fail(f"tools: extract_features' forward gave non-finite blobs on {name}")
            shapes = {k: v.shape for k, v in host.items()}
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["extract_ms"] = {k: statistics.median(v) for k, v in split.items()}
        if list(shapes) != sorted(blobs) or \
                shapes["conv4_3"] != (cfg.input_hw[0] // 8, cfg.input_hw[1] // 8, 512):
            fail(f"tools: extract_features' blobs {shapes}")
        log(f"tools (d): extract_features' forward on {FLAGSHIP} (deploy, "
            f"{cfg.input_hw[0]}x{cfg.input_hw[1]}, float32, TF32 off) over the 8 "
            f"scenes, {len(blobs)} blobs ({', '.join(f'{k} {list(v)}' for k, v in shapes.items())}): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in out["extract_ms"].items())
            + f" an image (median of 7), peak {out['peak_gib']:.2f} GiB")
        del params, fwd, feats
        # the card against the CPU on the tiny config, two scenes
        tcfg = zoo.tiny_test_config()
        tp = M.init_params(torch.Generator().manual_seed(SEED + 31), tcfg, device="cpu")
        tblobs = ["conv4_3", "conv5_3"] + [br.name for br in tcfg.branches]
        f_cpu = TL.feature_forward(tp, tcfg, tblobs)
        f_dev = TL.feature_forward({k: {n: t.to(dev) for n, t in p.items()}
                                    for k, p in tp.items()}, tcfg, tblobs)
        worst = 0.0
        for name in scenes[:2]:
            x = torch.from_numpy(TL.feature_input(decoded[name], tcfg))[None]
            a, b = f_cpu(x), f_dev(x.to(dev))
            for k in a:
                ref, got = a[k].numpy(), b[k].cpu().numpy()
                scale = np.abs(ref).max()
                worst = max(worst, float(np.abs(got - ref).max() / scale))
                if not np.allclose(got, ref, rtol=TOOLS_TOL, atol=TOOLS_TOL * scale):
                    fail(f"tools: extract_features' {k} on the card differs from the "
                         f"CPU's beyond rtol {TOOLS_TOL} / atol {TOOLS_TOL} * max|ref|")
        out["tiny_err"] = worst
        log(f"tools (d): the tiny config's {len(tblobs)} blobs on the card equal the "
            f"CPU's within rtol {TOOLS_TOL} / atol {TOOLS_TOL} * max|ref| (max |err| "
            f"{worst:.2e} of max|ref|), two scenes")
        # cli extract_features: the ImportError naming h5py before any image is
        # read, or (with h5py) the file, read back equal to the forward's blobs
        reads = []
        real_imread = image_io.imread

        def counted(path):
            reads.append(path)
            return real_imread(path)

        has_h5py = importlib.util.find_spec("h5py") is not None
        h5 = os.path.join(root, "features.h5")
        image_io.imread = counted
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["extract_features", "--zoo", "tiny-test", "--image-dir",
                               kitti, "--blobs", ",".join(tblobs), "--iterations", "2",
                               "-o", h5])
            raised = None
        except ImportError as e:
            raised = str(e)
        finally:
            image_io.imread = real_imread
        if not has_h5py and (raised is None or "h5py" not in raised or reads):
            fail(f"tools: cli extract_features without h5py: {raised!r} after "
                 f"{len(reads)} image reads")
        if has_h5py:
            import h5py
            cp = M.init_params(torch.Generator().manual_seed(0), tcfg, device=dev)
            fc = TL.feature_forward(cp, tcfg, tblobs)
            with h5py.File(h5, "r") as f:
                for i, name in enumerate(scenes[:2]):
                    x = torch.from_numpy(TL.feature_input(decoded[name], tcfg))[None]
                    want = {k: v[0].float().cpu().numpy() for k, v in fc(x.to(dev)).items()}
                    if rc != 0 or list(f) != sorted(tblobs) or any(
                            not np.allclose(f[k][i], want[k], rtol=TOOLS_TOL,
                                            atol=TOOLS_TOL * np.abs(want[k]).max())
                            for k in want):
                        fail("tools: cli extract_features' file differs from the forward")
        out["extract_cli"] = "wrote the HDF5 file" if has_h5py else f"ImportError: {raised}"
        log(f"tools (d): cli extract_features -> {out['extract_cli']} "
            f"({len(reads)} images read first)")

        # -- (f) no kernel, no jax, mscnn_tpu or cv2 ---------------------------
        out["launches"] = counts()
        if any(out["launches"].values()):
            fail(f"tools: a TPU-kernel port launched on a path without one: "
                 f"{out['launches']}")
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "mscnn_tpu", "cv2")]
        if loaded:
            fail(f"tools: {sorted(loaded)[:5]} imported")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > 60:
        fail(f"tools: phase 20 took {out['seconds']:.1f} s (60 s at most)")
    log(f"tools (f): no K1-K4 launch ({out['launches']}), no jax, mscnn_tpu or cv2 "
        f"module; phase 20 took {out['seconds']:.1f} s")
    return out


# -- phase 21: data parallelism ----------------------------------------------

DP_BATCH = 4        # the global batch of (a) and (b)
DP_STEPS = 2
DP_TOL = 1e-2       # (b): each moved leaf within 1e-2 of its move (+ 4 spacings)


def dp_flagship(dev, compute_dtype="bfloat16"):
    """Phase 21's training case (bench.py:87-134's spec): the flagship's
    stage-2 step at 768x1024, bf16, the fused conv1 (K2) and K1, seeded
    nonzero biases; (cfg, tspec, sspec, params, lr_mults, decay_mults, the
    global batch). compute_dtype "float32": the same step in float32 with
    the plain conv1 (K2 is bf16)."""
    import torch

    from mscnn_torch.data import synthetic as TSY
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=False),
                              compute_dtype=compute_dtype,
                              pallas_conv1=compute_dtype == "bfloat16")
    th, tw = cfg.input_hw
    tspec = TT.TrainSpec(stage=2)
    sspec = TS.SolverSpec(type="sgd", base_lr=5e-5, lr_policy="step", gamma=0.1,
                          stepsize=10000, momentum=0.9, weight_decay=5e-4)
    params = nonzero_biases(M.init_params(torch.Generator().manual_seed(SEED), cfg,
                                          device=dev), SEED + 7)
    batch = TSY.make_batch(cfg, batch=DP_BATCH, seed=SEED, with_labels=False, device=dev)
    batch["image"] = torch.randint(0, 256, (DP_BATCH, th, tw, 3), dtype=torch.uint8,
                                   generator=torch.Generator().manual_seed(SEED + 21)
                                   ).to(dev)
    return (cfg, tspec, sspec, params, M.param_lr_multipliers(params, cfg),
            M.param_decay_multipliers(params, cfg), batch)


def dp_draws(cfg, tspec, batch_size, n_gt, dev, rank):
    """Rank `rank`'s draws of each step (the loop's generators: JAX's
    fold_in(key, rank))."""
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train import train_step as TT

    return [TT.sample_draws(LP.iteration_generator(SEED, s, dev, rank), cfg, tspec,
                            batch_size, n_gt=n_gt) for s in range(DP_STEPS)]


def reference_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mscnn_tpu", "cv2"))


def dp_rank_main(argv):
    """Phase 21 (b)'s rank: `chip_smoke.py --dp-rank R --port P --out DIR`.
    Two ranks share cuda:0 over gloo (NCCL refuses two ranks on one card),
    batch 2 each, DP_STEPS steps of the flagship case; its start-up (the
    interpreter, torch, the kernels' libraries, a CUDA context) runs while
    the parent measures (a), the rest once DIR/go exists. Writes its
    params, launches, step ms and loaded modules to DIR/rank{R}.pt."""
    import torch

    from mscnn_torch.ops.kernels import build
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
    from mscnn_torch.ops.kernels import int8_kernel as IK
    from mscnn_torch.ops.kernels import nms_kernel as NK
    from mscnn_torch.parallel import distributed as D
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.train import train_step as TT
    from mscnn_torch.train import solver as TS

    args = argparse.ArgumentParser()
    args.add_argument("--dp-rank", type=int, required=True)
    args.add_argument("--port", type=int, required=True)
    args.add_argument("--out", required=True)
    a = args.parse_args(argv)
    build.build()                       # the parent built them: loads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros((), device=dev)          # the CUDA context
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(a.out, "go")):
        if time.perf_counter() - t0 > 240:
            raise TimeoutError("phase 21 (b): no go from the parent in 240 s")
        time.sleep(0.05)
    D.initialize(f"127.0.0.1:{a.port}", 2, a.dp_rank, device=dev, backend="gloo")
    try:
        mesh = make_mesh((2,), ("data",), [dev, dev])
        cfg, tspec, sspec, params, lm, dm, batch = dp_flagship(dev)
        state = TT.replicate_state({"params": params,
                                    "solver": TS.init_state(params, sspec)}, mesh)
        local = TT.shard_batch(batch, mesh)
        step = TT.make_train_step(cfg, tspec, sspec, lr_mults=lm, decay_mults=dm,
                                  mesh=mesh)
        draws = dp_draws(cfg, tspec, DP_BATCH // 2, batch["gt_boxes"].shape[1], dev,
                         a.dp_rank)
        NK.launches = CK.launches = IK.launches = K3.launches = 0
        times, split = [], {}
        for s in range(DP_STEPS):
            evs = []

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                evs.append((name, ev))

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark("start")
            state, m = step(state, local, draws=draws[s], mark=mark)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            split = {name: a_.elapsed_time(b_) for (_, a_), (name, b_) in zip(evs, evs[1:])}
        torch.save({"params": {n: {k: v.cpu() for k, v in p.items()}
                               for n, p in state["params"].items()},
                    "loss": float(m["loss"]),
                    "launches": {"nms": NK.launches, "conv1_pool": CK.launches,
                                 "int8_gemm": IK.launches, "conv1_v5": K3.launches},
                    "ms": times, "split": split, "modules": reference_modules()},
                   os.path.join(a.out, f"rank{a.dp_rank}.pt"))
    finally:
        D.shutdown()


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def leaf_errors(got, want, p0, tag="data parallel (b)", tol=DP_TOL):
    """(max over the moved leaves of |got - want| / max|want - p0|, whether
    all are equal, the share of the values bit-equal): each leaf within tol
    of its move, plus 4 float32 spacings of max|want|."""
    import torch
    worst, equal, same, total = 0.0, True, 0, 0
    for n, p in want.items():
        for k, w in p.items():
            g, w0 = got[n][k].to(w.device), p0[n][k]
            equal = equal and torch.equal(g, w)
            same += int((g == w).sum().item())
            total += w.numel()
            move = (w - w0).abs().max().item()
            err = (g - w).abs().max().item()
            if move == 0.0:
                if err != 0.0:
                    fail(f"{tag}: {n}.{k} moved by {err} where the one-process "
                         "step left it")
                continue
            spacing = 4 * torch.finfo(torch.float32).eps * w.abs().max().item()
            if err > tol * move + spacing:
                fail(f"{tag}: {n}.{k} off the one-process step by {err} (move {move})")
            worst = max(worst, err / move)
    return worst, equal, same / max(total, 1)


def clone_state(state):
    """A copy of a train state {"params", "solver"} on its device."""
    return {"params": {n: {k: v.clone() for k, v in p.items()}
                       for n, p in state["params"].items()},
            "solver": {k: ({n: {kk: vv.clone() for kk, vv in p.items()}
                            for n, p in v.items()} if isinstance(v, dict) else v.clone())
                       for k, v in state["solver"].items()}}


def dp_world1(dev, counts, zero_counts, rec, out):
    """Phase 21 (a): the flagship step through `make_train_step(mesh=)` over
    NCCL at world size 1 against the step without a mesh (module notes);
    folds its figures into out. Returns the case (cfg, tspec, sspec,
    params, lr_mults, decay_mults, batch, n_gt) for (b)."""
    import torch
    import torch.distributed as dist

    from mscnn_torch.parallel import distributed as D
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg, tspec, sspec, params, lm, dm, batch = dp_flagship(dev)
    n_gt = batch["gt_boxes"].shape[1]
    draws = dp_draws(cfg, tspec, DP_BATCH, n_gt, dev, 0)
    state0 = {"params": params, "solver": TS.init_state(params, sspec)}
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    if dist.get_backend() != "nccl":
        fail(f"data parallel (a): the process group's backend is {dist.get_backend()}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh1 = make_mesh((1,), ("data",), [dev])
        plain = TT.make_train_step(cfg, tspec, sspec, lr_mults=lm, decay_mults=dm)
        meshed = TT.make_train_step(cfg, tspec, sspec, lr_mults=lm, decay_mults=dm,
                                    mesh=mesh1)
        local = TT.shard_batch(batch, mesh1)
        # warm-up: the NCCL communicator, cuDNN's plans (a throwaway state)
        meshed(TT.replicate_state(state0, mesh1), local, draws=draws[0])
        plain(clone_state(state0), batch, draws=draws[0])
        torch.cuda.synchronize()
        sink = {"nms": [], "conv1": [], "int8": []}
        torch.cuda.set_sync_debug_mode("error")
        try:
            ref = clone_state(state0)
            for s in range(DP_STEPS):
                ref, rm = plain(ref, batch, draws=draws[s])
            st = TT.replicate_state(state0, mesh1)
            rec(True, sink)
            zero_counts()
            for s in range(DP_STEPS):
                st, sm = meshed(st, local, draws=draws[s])
            launches_a = counts()
            rec(False, sink)
        except RuntimeError as e:
            fail(f"data parallel (a): a step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["launches"]["world 1 (NCCL), 2 steps"] = launches_a
        if launches_a["nms"] != DP_STEPS or launches_a["conv1_pool"] != DP_STEPS:
            fail(f"data parallel (a): launches {launches_a}, expected {DP_STEPS} K1 "
                 f"and {DP_STEPS} K2")
        held = hold_to_plain(sink, "data parallel (a)", out)
        del sink
        for n, p in ref["params"].items():
            for k, v in p.items():
                if not torch.equal(v, st["params"][n][k]):
                    fail(f"data parallel (a): {n}.{k} differs from the step without "
                         "a mesh")
        for n, p in ref["solver"]["h1"].items():
            for k, v in p.items():
                if not torch.equal(v, st["solver"]["h1"][n][k]):
                    fail(f"data parallel (a): the history of {n}.{k} differs")
        if float(rm["loss"]) != float(sm["loss"]) or not math.isfinite(float(sm["loss"])):
            fail(f"data parallel (a): loss {float(sm['loss'])} vs {float(rm['loss'])}")
        log(f"data parallel (a): flagship stage-2 step, batch {DP_BATCH} at "
            f"{cfg.input_hw[0]}x{cfg.input_hw[1]}, bf16, K2 + K1, nonzero biases, "
            f"{DP_STEPS} steps through make_train_step(mesh=) over NCCL at world size 1 "
            f"under sync debug mode 'error': params, history and loss "
            f"({float(sm['loss']):.5f}) bit-equal to the step without a mesh; "
            f"launches {launches_a}; {held}")
        del ref, st
        torch.use_deterministic_algorithms(False)
        # step ms, in turns (plain, mesh, mesh, plain, ...): host clock, synchronised
        ms = {"plain": [], "mesh": []}
        sp, sm_ = clone_state(state0), TT.replicate_state(state0, mesh1)
        for order in (("plain", "mesh"), ("mesh", "plain"), ("plain", "mesh")):
            for tag in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tag == "plain":
                    sp, _ = plain(sp, batch, draws=draws[0])
                else:
                    sm_, _ = meshed(sm_, local, draws=draws[0])
                torch.cuda.synchronize()
                ms[tag].append((time.perf_counter() - t0) * 1e3)
        del sp, sm_
        grads = [torch.empty_like(v) for n, p in params.items() for k, v in p.items()
                 if lm[n][k] != 0.0]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        frozen = sum(v.numel() for n, p in params.items() for k, v in p.items()
                     if lm[n][k] == 0.0)
        ar_ms = cuda_ms(lambda: D.all_reduce_mean_(grads), iters=5, warmup=2)
        flat = torch.empty(nbytes // 4, device=dev)
        nccl_ms = cuda_ms(lambda: dist.all_reduce(flat), iters=5, warmup=2)
        del grads, flat
        out["a"] = {"plain_ms": statistics.median(ms["plain"]),
                    "mesh_ms": statistics.median(ms["mesh"]), "ms": ms,
                    "all_reduce_mb": nbytes / 1e6, "all_reduce_ms": ar_ms,
                    "nccl_ms": nccl_ms, "frozen_params": frozen}
        log(f"data parallel (a): step {out['a']['mesh_ms']:.2f} ms with the mesh, "
            f"{out['a']['plain_ms']:.2f} without (median of 3, in turns: "
            f"{json.dumps({k: [round(v, 2) for v in vs] for k, vs in ms.items()})}); "
            f"all-reduce {nbytes / 1e6:.1f} MB of float32 gradients "
            f"({frozen} frozen parameters left out): {ar_ms:.3f} ms with the flat "
            f"buffer's copies, the NCCL call alone {nccl_ms:.3f} ms (world size 1)")
    finally:
        D.shutdown()
        torch.use_deterministic_algorithms(False)
    del state0
    torch.cuda.empty_cache()
    return cfg, tspec, sspec, params, lm, dm, batch, n_gt


def data_parallel(dev, counts, zero_counts, rec):
    """Phase 21 (module notes): (a) the flagship step through
    `make_train_step(mesh=)` over NCCL at world size 1, bit-equal to the
    step without a mesh, no host sync; the all-reduce's bytes and ms; (b)
    two gloo ranks sharing cuda:0 against one process applying the mean of
    their micro-batches' gradients; (c) the deploy mesh forwards and
    `cli detect --devices`; (d) no jax, mscnn_tpu or cv2 anywhere. rec(on,
    sink) records the kernels' launches. Returns the phase's figures."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mscnn_torch import cli
    from mscnn_torch import inference as I
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo
    from mscnn_torch.ops import quant as Q
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    t_phase = time.perf_counter()
    out = {"launches": {}, "nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0,
           "int8_err": 0.0}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # (b)'s ranks start first: their start-up overlaps (a); they go on at "go"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                               str(r), "--port", str(port), "--out", tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]

    try:
        a_out = dp_world1(dev, counts, zero_counts, rec, out)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    cfg, tspec, sspec, params, lm, dm, batch, n_gt = a_out
    t_a = time.perf_counter() - t_phase

    # -- (b) two gloo ranks on cuda:0 ----------------------------------------------
    try:
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "go"), "w"):
            pass
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"data parallel (b): rank {r} exited {p.returncode}:\n{text[-3000:]}")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
               for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, g in enumerate(got):
        if g["modules"]:
            fail(f"data parallel (b): rank {r} loaded {g['modules'][:5]}")
        if g["launches"] != {"nms": DP_STEPS, "conv1_pool": DP_STEPS, "int8_gemm": 0,
                             "conv1_v5": 0}:
            fail(f"data parallel (b): rank {r} launched {g['launches']}")
    for n, p in got[0]["params"].items():
        for k, v in p.items():
            if not torch.equal(v, got[1]["params"][n][k]):
                fail(f"data parallel (b): the ranks' {n}.{k} differ")
    # one process: the mean of the two micro-batches' gradients (iter_size 2
    # sums them and the update divides by 2), each with its rank's draws
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        two = dataclasses.replace(sspec, iter_size=2)
        one = TT.make_train_step(cfg, tspec, two, lr_mults=lm, decay_mults=dm)
        half = DP_BATCH // 2
        micro = TT.stack_microbatches([
            {k: tuple(m[r * half:(r + 1) * half] for m in v) if isinstance(v, tuple)
             else v[r * half:(r + 1) * half] for k, v in batch.items()} for r in range(2)])
        rdraws = [dp_draws(cfg, tspec, half, n_gt, dev, r) for r in range(2)]
        st = clone_state({"params": params, "solver": TS.init_state(params, two)})
        for s in range(DP_STEPS):
            st, om = one(st, micro, draws=[rdraws[0][s], rdraws[1][s]])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    worst, equal, _ = leaf_errors(got[0]["params"], st["params"], params)
    out["b"] = {"ms": [g["ms"] for g in got], "split": got[0]["split"],
                "launches": [g["launches"] for g in got], "worst": worst,
                "bit_equal": equal, "seconds": ranks_s,
                "loss": [got[0]["loss"], float(om["loss"])]}
    for r, g in enumerate(got):
        out["launches"][f"gloo rank {r} of 2, 2 steps"] = g["launches"]
    log(f"data parallel (b): two gloo ranks on cuda:0, batch {DP_BATCH // 2} each, "
        f"{DP_STEPS} steps: ranks' params bit-identical; against one process applying "
        f"the mean of the two micro-batches' gradients: "
        + ("bit-equal" if equal else f"worst leaf {worst:.3g} of its move (gate "
                                     f"{DP_TOL})")
        + f"; launches {[g['launches'] for g in got]}; rank step ms "
        f"{[[round(t, 1) for t in g['ms']] for g in got]}, rank 0's second step split "
        f"{json.dumps({k: round(v, 2) for k, v in got[0]['split'].items()})}; the ranks' "
        f"steps took {ranks_s:.1f} s after (a)'s {t_a:.1f} s")
    del st, got, params, batch
    torch.cuda.empty_cache()

    # -- (c) the deploy mesh: forwards, detect_batch, int8, the CLI ----------------
    dcfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=True, max_out=256),
                               compute_dtype="bfloat16", pallas_conv1=True)
    dp_ = M.cast_params(M.init_params(torch.Generator().manual_seed(SEED), dcfg,
                                      device=dev), torch.bfloat16)
    h, w = dcfg.input_hw
    gen = torch.Generator().manual_seed(SEED + 31)
    imgs = torch.randint(0, 256, (DP_BATCH, h, w, 3), dtype=torch.uint8, generator=gen)
    x = imgs.to(dev).float() - torch.tensor(MEAN, device=dev)
    mesh1 = make_mesh((1,), ("data",), [dev])
    with torch.inference_mode():
        want = I.make_forward(dp_, dcfg)(dp_, x)
        sink = {"nms": [], "conv1": [], "int8": []}
        rec(True, sink)
        zero_counts()
        got = I.make_forward(dp_, dcfg, mesh=mesh1)(dp_, x)
        torch.cuda.synchronize()
        launches_c = counts()
        rec(False, sink)
    same = same_outputs("data parallel (c) make_forward(mesh=)",
                        {k: v for k, v in got.items() if k != "proposals"},
                        {k: v for k, v in want.items() if k != "proposals"})
    if same:
        fail("data parallel (c): make_forward(mesh=[cuda:0]) is not bit-equal")
    out["launches"]["make_forward(mesh=[cuda:0])"] = launches_c
    bgr = [im.numpy() for im in imgs]
    spec = I.DetectSpec()
    one_dev = I.detect_batch(dp_, bgr, dcfg, spec)
    fm = I.make_forward(dp_, dcfg, mesh=mesh1)
    rec(True, sink)
    zero_counts()
    meshed = I.detect_batch(dp_, bgr, dcfg, spec, fwd=fm)
    launches_d = counts()
    rec(False, sink)
    for a_, b_ in zip(meshed, one_dev):
        for k in a_:
            if not np.array_equal(a_[k], b_[k]):
                fail(f"data parallel (c): detect_batch over the mesh: {k} differs")
    out["launches"]["detect_batch over the mesh"] = launches_d
    if launches_c["conv1_pool"] != 1 or launches_c["nms"] != 1 or \
            launches_d["conv1_pool"] != 1 or launches_d["nms"] != 2:
        fail(f"data parallel (c): launches {launches_c}, {launches_d}")
    # int8 + heads (detect --int8 --int8-heads): one calibration image
    cfg8 = dataclasses.replace(dcfg, pallas_conv1=False, int8_trunk=True,
                               int8_roi_head=True)
    p32 = M.init_params(torch.Generator().manual_seed(SEED), cfg8, device=dev)
    cal = np.random.RandomState(1).randn(1, h, w, 3).astype(np.float32) * 40.0
    q32, _, _ = calibrate_int8(Q, p32, cfg8, cal)
    p8 = M.cast_params(q32, torch.bfloat16)
    del p32, q32
    with torch.inference_mode():
        want8 = I.make_forward(p8, cfg8)(p8, x)
        rec(True, sink)
        zero_counts()
        got8 = I.make_forward(p8, cfg8, mesh=mesh1)(p8, x)
        torch.cuda.synchronize()
        launches_8 = counts()
        rec(False, sink)
    if same_outputs("data parallel (c) int8", {k: v for k, v in got8.items()
                                                if k != "proposals"},
                    {k: v for k, v in want8.items() if k != "proposals"}):
        fail("data parallel (c): the int8 mesh forward is not bit-equal")
    out["launches"]["int8 make_forward(mesh=[cuda:0])"] = launches_8
    if launches_8["int8_gemm"] < 15 or launches_8["nms"] != 1:
        fail(f"data parallel (c): int8 launches {launches_8}")
    held = hold_to_plain(sink, "data parallel (c)", out)
    del sink, p8, want8, got8, want, got, x
    log(f"data parallel (c): make_forward(mesh=[cuda:0]) bit-equal to make_forward on "
        f"the flagship deploy graph (batch {DP_BATCH}, {h}x{w}, bf16, K2) and in "
        f"int8 + heads; detect_batch over the mesh (a chunk's decode on its device) "
        f"equal to detect_batch; launches {launches_c}, {launches_d}, {launches_8}; "
        f"{held}")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    try:
        img_dir, _, _ = write_kitti_pngs(root, 2, SEED + 41)
        base = ["detect", "--zoo", "kitti_car/mscnn-8s-768-trainval", "--bf16",
                "--image-dir", img_dir]
        n_dev = torch.cuda.device_count()
        if n_dev < 2:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(base + ["--devices", "2", "--output-dir",
                                     os.path.join(root, "d2")])
                fail("data parallel (c): cli detect --devices 2 ran on one card")
            except SystemExit as e:
                if str(e) != f"mesh shape (2,) needs 2 devices, have {n_dev}":
                    fail(f"data parallel (c): cli detect --devices 2 said {e}")
                said = str(e)
            if os.path.exists(os.path.join(root, "d2")):
                fail("data parallel (c): cli detect --devices 2 wrote labels")
        else:
            said = f"ran on {n_dev} cards"
        for tag, extra in (("one", []), ("devices1", ["--devices", "1"])):
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(base + extra + ["--output-dir", os.path.join(root, tag)]):
                    fail(f"data parallel (c): cli detect {extra} failed")
        files = sorted(os.listdir(os.path.join(root, "one")))
        if not files or files != sorted(os.listdir(os.path.join(root, "devices1"))) or any(
                open(os.path.join(root, "one", f)).read()
                != open(os.path.join(root, "devices1", f)).read() for f in files):
            fail("data parallel (c): cli detect --devices 1 wrote other labels")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"data parallel (c): cli detect --devices 2 on this machine: {said!r}; "
        f"cli detect --devices 1 wrote the {len(files)} label files detect writes")

    # -- (d) no jax, mscnn_tpu or cv2 ------------------------------------------------
    if reference_modules():
        fail(f"data parallel: {reference_modules()[:5]} imported")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"data parallel (d): no jax, mscnn_tpu or cv2 module in this process or "
        f"either rank; phase 21 took {out['seconds']:.1f} s")
    return out


# -- phase 22: the data x space step -------------------------------------------

SPMD_TOL = 1e-2     # (b): the loss and metrics of each step, relative (+ 1e-6)
# (b): each param leaf of the bf16 run within 3e-2 of its move. The
# trunk's weight gradients are bf16: each rank's band sum is rounded to
# bf16 before the ranks' float32 sum, where the one-process step rounds the
# whole sum once (one bf16 step on the tiny config, CPU: 0.4-0.7% relative
# L2 in the trunk's gradients, against 2e-6 in float32); phase 21's 1e-2
# holds for micro-batches of the same shapes, bit-equal there
SPMD_PARAM_TOL = 3e-2
# (b)'s float32 run (the same step, plain conv1): the params within phase
# 21's DP_TOL of their move, the loss and metrics within 1e-3 relative, so
# that a halo gradient dropped or counted twice shows on the card
SPMD_TOL32 = 1e-3
MEM_TRACE_ENTRIES = 400_000


def record_memory(on):
    """Start (with Python stacks) or stop the CUDA caching allocator's
    history of allocations and frees."""
    import torch
    if on:
        torch.cuda.memory._record_memory_history(max_entries=MEM_TRACE_ENTRIES,
                                                 stacks="python")
    else:
        torch.cuda.memory._record_memory_history(enabled=None)


def memory_peak_sites(snap, device, top=8):
    """Where the bytes live at the peak of a recorded history
    (`torch.cuda.memory._snapshot()`): the trace's allocations and frees
    replayed from the start of the recording; returns (the most bytes
    allocated at once above the start, [(site, MB), ...] of the blocks live
    at that moment, the largest first). A site is the innermost frame of
    the repo that allocated the block (file:line function), or "no Python
    frame" (the backward's own allocations, made on autograd's thread)."""
    trace = snap["device_traces"][device]
    if any(e["action"] == "oom" for e in trace):
        fail("memory history: the recording saw an out-of-memory")
    live, cur, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = i
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            del live[e["addr"]]
            cur -= e["size"]
    held = {}
    for i, e in enumerate(trace[:at + 1]):
        if e["action"] == "alloc":
            held[e["addr"]] = e
        elif e["action"] in ("free_requested", "free_completed"):
            held.pop(e["addr"], None)
    here = os.path.dirname(os.path.abspath(__file__))
    sites = {}
    for e in held.values():
        site = "no Python frame"
        for f in e.get("frames") or ():
            fn = f.get("filename", "")
            if fn.startswith(here) and "/torch/" not in fn:
                site = f"{os.path.relpath(fn, here)}:{f['line']} {f['name']}"
                break
        sites[site] = sites.get(site, 0) + e["size"]
    return peak, [(k, round(v / 1e6, 1)) for k, v in
                  sorted(sites.items(), key=lambda kv: -kv[1])[:top]]


def spmd_split(evs):
    """[(name, CUDA event)] marks -> ms summed by the name that ends each
    segment (the band's marks repeat: "trunk", "halo", "backward", ...)."""
    out = {}
    for (_, a), (name, b) in zip(evs, evs[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def spmd_rank_main(argv):
    """Phase 22 (b)'s rank: `chip_smoke.py --spmd-rank R --port P --out DIR`.
    Two ranks of a (1, 2) ("data", "space") mesh share cuda:0 over gloo,
    each holding a 384-row band of the flagship batch's four 768x1024
    images; SPMD steps of `parallel/spmd.py` with the global batch's draws.
    Its start-up runs while the parent measures (a), the rest once DIR/go
    exists. K2's and K1's launches of the last step are held to their
    plain versions here; the first step records the allocator's history
    (`memory_peak_sites`). Then the same two steps in float32 (plain
    conv1). Writes its params, metrics, launches, step ms and split, peak
    memory and where it sits, the band's bytes, the float32 run's params
    and metrics and the loaded modules to DIR/rank{R}.pt."""
    import torch

    from mscnn_torch.ops import nms as nms_ops
    from mscnn_torch.ops.kernels import build
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
    from mscnn_torch.ops.kernels import int8_kernel as IK
    from mscnn_torch.ops.kernels import nms_kernel as NK
    from mscnn_torch.parallel import distributed as D
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.parallel import spmd as SP
    from mscnn_torch.train import solver as TS

    args = argparse.ArgumentParser()
    args.add_argument("--spmd-rank", type=int, required=True)
    args.add_argument("--port", type=int, required=True)
    args.add_argument("--out", required=True)
    a = args.parse_args(argv)
    build.build()                       # the parent built them: loads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros((), device=dev)          # the CUDA context
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(a.out, "go")):
        if time.perf_counter() - t0 > 240:
            raise TimeoutError("phase 22 (b): no go from the parent in 240 s")
        time.sleep(0.05)
    D.initialize(f"127.0.0.1:{a.port}", 2, a.spmd_rank, device=dev, backend="gloo")
    try:
        mesh = make_mesh((1, 2), ("data", "space"), [dev, dev])
        cfg, tspec, sspec, params, lm, dm, batch = dp_flagship(dev)
        draws = dp_draws(cfg, tspec, DP_BATCH, batch["gt_boxes"].shape[1], dev, 0)
        step = SP.make_train_step_spmd(cfg, tspec, sspec, mesh, lr_mults=lm,
                                       decay_mults=dm)(batch)
        state = SP.place_state({"params": params, "solver": TS.init_state(params, sspec)},
                               mesh)
        local = SP.place_batch(batch, mesh)
        del batch, params
        calls = {"nms": [], "conv1": []}
        nms_cuda, conv1_cuda = NK.nms_xywh_cuda, CK.conv1_pool_cuda

        def rec_nms(*args_, **kw):
            out = nms_cuda(*args_, **kw)
            calls["nms"].append(([t.clone() if torch.is_tensor(t) else t for t in args_], kw, out))
            return out

        def rec_conv1(*args_):
            out = conv1_cuda(*args_)
            calls["conv1"].append(([t.clone() for t in args_], out.clone()))
            return out

        NK.launches = CK.launches = IK.launches = K3.launches = 0
        times, metrics, split, mem, sites = [], [], {}, {}, None
        for s in range(DP_STEPS):
            evs = []

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                evs.append((name, ev))

            last = s == DP_STEPS - 1
            if last:
                NK.nms_xywh_cuda, CK.conv1_pool_cuda = rec_nms, rec_conv1
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if s == 0:
                record_memory(True)
            t0 = time.perf_counter()
            mark("start")
            state, m = step(state, local, draws=draws[s], mark=mark)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            NK.nms_xywh_cuda, CK.conv1_pool_cuda = nms_cuda, conv1_cuda
            if s == 0:
                sites = memory_peak_sites(torch.cuda.memory._snapshot(), dev.index)
                sites = {"peak": sites[0], "sites": sites[1], "before": before,
                         "max_allocated": torch.cuda.max_memory_allocated()}
                record_memory(False)
            mem = {"before": before, "peak": torch.cuda.max_memory_allocated()}
            split = spmd_split(evs)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {"nms": NK.launches, "conv1_pool": CK.launches,
                    "int8_gemm": IK.launches, "conv1_v5": K3.launches}
        stats = step.last_stats
        params_bf16 = {n: {k: v.cpu() for k, v in p.items()}
                       for n, p in state["params"].items()}
        del state, local, step
        # the float32 run: the same two steps with the plain conv1
        cfg32, _, _, params32, _, _, batch32 = dp_flagship(dev, "float32")
        draws32 = dp_draws(cfg32, tspec, DP_BATCH, batch32["gt_boxes"].shape[1], dev, 0)
        step32 = SP.make_train_step_spmd(cfg32, tspec, sspec, mesh, lr_mults=lm,
                                         decay_mults=dm)(batch32)
        state32 = SP.place_state({"params": params32,
                                  "solver": TS.init_state(params32, sspec)}, mesh)
        local32 = SP.place_batch(batch32, mesh)
        del batch32, params32
        metrics32 = []
        for s in range(DP_STEPS):
            state32, m = step32(state32, local32, draws=draws32[s])
            metrics32.append({k: float(v) for k, v in m.items()})
        held = {"nms": [], "conv1": []}
        for args_, kw, got in calls["nms"]:
            held["nms"].append(nms_equal(got, nms_ops.nms_xywh_plain(*args_, **kw)))
        for args_, got in calls["conv1"]:
            err, tol, eq, ulps, ok = conv1_compare(
                got.float(), CK.conv1_pool_plain(*args_).float())
            held["conv1"].append({"shape": list(args_[0].shape), "err": err, "share": eq,
                                  "ok": ok})
        torch.save({"params": params_bf16,
                    "metrics": metrics, "launches": launches, "held": held,
                    "ms": times, "split": split, "mem": mem, "mem_sites": sites,
                    "stats": {"halo_bytes": stats.halo_bytes,
                              "halo_calls": stats.halo_calls,
                              "gather_bytes": stats.gather_bytes},
                    "params32": {n: {k: v.cpu() for k, v in p.items()}
                                 for n, p in state32["params"].items()},
                    "metrics32": metrics32, "modules": reference_modules()},
                   os.path.join(a.out, f"rank{a.spmd_rank}.pt"))
    finally:
        D.shutdown()


def spmd_world1(dev, counts, zero_counts, rec, out):
    """Phase 22 (a): the flagship step through `make_train_step_spmd` on a
    (1, 1) mesh over NCCL at world size 1 against the step without a mesh;
    folds its figures into out. Returns (the case, the one-process state
    after DP_STEPS steps and its metrics), which (b) is held to."""
    import torch
    import torch.distributed as dist

    from mscnn_torch.parallel import distributed as D
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.parallel import spmd as SP
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg, tspec, sspec, params, lm, dm, batch = dp_flagship(dev)
    draws = dp_draws(cfg, tspec, DP_BATCH, batch["gt_boxes"].shape[1], dev, 0)
    state0 = {"params": params, "solver": TS.init_state(params, sspec)}
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    if dist.get_backend() != "nccl":
        fail(f"spmd (a): the process group's backend is {dist.get_backend()}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh11 = make_mesh((1, 1), ("data", "space"), [dev])
        plain = TT.make_train_step(cfg, tspec, sspec, lr_mults=lm, decay_mults=dm)
        spmd = SP.make_train_step_spmd(cfg, tspec, sspec, mesh11, lr_mults=lm,
                                       decay_mults=dm)(batch)
        local = SP.place_batch(batch, mesh11)
        # warm-up (a throwaway state): cuDNN's plans
        spmd(SP.place_state(state0, mesh11), local, draws=draws[0])
        torch.cuda.synchronize()
        sink = {"nms": [], "conv1": [], "int8": []}
        ref, rms = clone_state(state0), []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s in range(DP_STEPS):
                ref, rm = plain(ref, batch, draws=draws[s])
                rms.append(rm)
            st = SP.place_state(state0, mesh11)
            rec(True, sink)
            zero_counts()
            for s in range(DP_STEPS):
                st, sm = spmd(st, local, draws=draws[s])
            launches_a = counts()
            rec(False, sink)
        except RuntimeError as e:
            fail(f"spmd (a): a step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["launches"]["(1, 1) NCCL world 1, 2 steps"] = launches_a
        if launches_a["nms"] != DP_STEPS or launches_a["conv1_pool"] != DP_STEPS:
            fail(f"spmd (a): launches {launches_a}, expected {DP_STEPS} K1 and "
                 f"{DP_STEPS} K2")
        held = hold_to_plain(sink, "spmd (a)", out)
        del sink
        for tree in ("params", "h1"):
            want = ref["params"] if tree == "params" else ref["solver"]["h1"]
            got = st["params"] if tree == "params" else st["solver"]["h1"]
            for n, p in want.items():
                for k, v in p.items():
                    if not torch.equal(v, got[n][k]):
                        fail(f"spmd (a): {tree} {n}.{k} differs from the step without "
                             "a mesh")
        if float(rm["loss"]) != float(sm["loss"]) or not math.isfinite(float(sm["loss"])):
            fail(f"spmd (a): loss {float(sm['loss'])} vs {float(rm['loss'])}")
        log(f"spmd (a): flagship stage-2 step, batch {DP_BATCH} at {cfg.input_hw[0]}x"
            f"{cfg.input_hw[1]}, bf16, K2 + K1, nonzero biases, {DP_STEPS} steps through "
            f"make_train_step_spmd on a (1, 1) mesh over NCCL at world size 1 under sync "
            f"debug mode 'error': params, history and loss ({float(sm['loss']):.5f}) "
            f"bit-equal to the step without a mesh; launches {launches_a}; {held}")
        del st
        torch.use_deterministic_algorithms(False)
        # the one-process step's ms and memory, which (b)'s ranks are set beside
        ms = []
        for _ in range(3):
            sp = clone_state(state0)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sp, _ = plain(sp, batch, draws=draws[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mem = {"before": before, "peak": torch.cuda.max_memory_allocated()}
            del sp
        # one more, untimed, with the allocator's history: where its peak sits
        sp = clone_state(state0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        record_memory(True)
        sp, _ = plain(sp, batch, draws=draws[0])
        torch.cuda.synchronize()
        peak, sites = memory_peak_sites(torch.cuda.memory._snapshot(),
                                        torch.cuda.current_device())
        record_memory(False)
        del sp
        out["a"] = {"plain_ms": statistics.median(ms), "ms": ms, "mem": mem,
                    "mem_sites": {"peak": peak, "sites": sites, "before": before,
                                  "max_allocated": torch.cuda.max_memory_allocated()}}
    finally:
        D.shutdown()
        torch.use_deterministic_algorithms(False)
    del state0
    torch.cuda.empty_cache()
    return (cfg, tspec, sspec, params, lm, dm, batch), ref, rms


def spmd_reference32(dev):
    """(b)'s float32 reference: the one-process step on the whole batch in
    float32 (plain conv1), DP_STEPS steps; (params before, params after,
    metrics of each step)."""
    import torch

    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg, tspec, sspec, params, lm, dm, batch = dp_flagship(dev, "float32")
    draws = dp_draws(cfg, tspec, DP_BATCH, batch["gt_boxes"].shape[1], dev, 0)
    plain = TT.make_train_step(cfg, tspec, sspec, lr_mults=lm, decay_mults=dm)
    p0 = {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()}
    st, ms = {"params": params, "solver": TS.init_state(params, sspec)}, []
    for s in range(DP_STEPS):
        st, m = plain(st, batch, draws=draws[s])
        ms.append({k: float(v) for k, v in m.items()})
    del batch
    torch.cuda.empty_cache()
    return p0, st["params"], ms


def gib(n):
    return n / 2 ** 30


def sites_text(ms):
    """`memory_peak_sites`' figures as a log fragment."""
    return (f"peak {gib(ms['peak']):.3f} GiB above the step's start (max allocated "
            f"{gib(ms['max_allocated'] - ms['before']):.3f}); live there: "
            + ", ".join(f"{site} {mb} MB" for site, mb in ms["sites"]))


def s2d_deploy(dev, counts, zero_counts, out):
    """Phase 22 (e): the flagship deploy forward (768x2560, batch 4, bf16,
    nonzero biases) with `--conv1 s2d` against the plain conv1: pool1 by
    `conv1_compare`'s gates, conv4_3 and the ROI head's outputs within
    2e-2 of max|ref|, ms of each (median of 5, CUDA events)."""
    import torch

    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo

    base = dataclasses.replace(zoo.kitti_car_8s_768(deploy=True, max_out=256),
                               compute_dtype="bfloat16")
    s2d = dataclasses.replace(base, s2d_conv1=True)
    p = M.cast_params(nonzero_biases(M.init_params(torch.Generator().manual_seed(SEED),
                                                   base, device=dev), SEED + 9),
                      torch.bfloat16)
    h, w = base.input_hw
    gen = torch.Generator().manual_seed(SEED + 51)
    x = (torch.randint(0, 256, (DP_BATCH, h, w, 3), dtype=torch.uint8, generator=gen)
         .to(dev).float() - torch.tensor(MEAN, device=dev))
    with torch.inference_mode():
        fp, fs = M.trunk(p, x, base), M.trunk(p, x, s2d)
        err, tol, eq, ulps, ok = conv1_compare(fs["pool1"].float(), fp["pool1"].float())
        if not ok:
            fail(f"spmd (e): the s2d pool1 != the plain conv1's (err {err}, share {eq})")
        ref = fp["conv4_3"].float()
        c43 = (fs["conv4_3"].float() - ref).abs().max().item() / ref.abs().max().item()
        del fp, fs
        zero_counts()
        op, os_ = M.deploy_forward(p, x, base), M.deploy_forward(p, x, s2d)
        torch.cuda.synchronize()
        launches = counts()
        for k in ("cls_pred", "bbox_pred"):
            a, b = os_[k], op[k]
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail(f"spmd (e): the s2d forward's {k} is not finite or of {tuple(b.shape)}")
        if launches["nms"] != 2 or launches["conv1_pool"]:
            fail(f"spmd (e): launches {launches}")
        ms = {"plain": cuda_ms(lambda: M.deploy_forward(p, x, base)),
              "s2d": cuda_ms(lambda: M.deploy_forward(p, x, s2d))}
    out["launches"]["s2d deploy forward + plain"] = launches
    out["s2d"] = {"pool1_err": err, "pool1_share": eq, "conv4_3_rel": c43, "ms": ms}
    if c43 > 2e-2:
        fail(f"spmd (e): the s2d trunk's conv4_3 is {c43} of max|ref| off the plain one")
    log(f"spmd (e): flagship deploy forward, batch {DP_BATCH} at {h}x{w}, bf16, "
        f"--conv1 s2d against the plain conv1: pool1 max err {err:.4g} (gate "
        f"{min(tol, ulps):.4g}), bit-equal share {eq:.4f}; conv4_3 {c43:.3g} of max|ref|; "
        f"forward {ms['s2d']:.3f} ms with s2d, {ms['plain']:.3f} ms plain (CUDA events, "
        f"median of 5); launches {launches}")
    del p, x


def spmd_phase(dev, counts, zero_counts, rec):
    """Phase 22 (module notes): (a) `make_train_step_spmd` on a (1, 1) mesh
    bit-equal to the step without a mesh, no host sync; (b) two gloo ranks
    of a (1, 2) mesh sharing cuda:0 against the one-process step on the
    whole batch, with each rank's peak memory, the halo, gather and
    all-reduce ms; (e) the s2d conv1 route in the deploy forward; (c) no
    jax, mscnn_tpu or cv2 anywhere. Returns the phase's figures."""
    import torch

    t_phase = time.perf_counter()
    out = {"launches": {}, "nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0,
           "int8_err": 0.0}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # (b)'s ranks start first: their start-up overlaps (a); they go on at "go"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spmd-rank",
                               str(r), "--port", str(port), "--out", tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        case, ref, rms = spmd_world1(dev, counts, zero_counts, rec, out)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    params = case[3]
    try:
        p0_32, ref32, rms32 = spmd_reference32(dev)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    t_a = time.perf_counter() - t_phase

    # -- (b) two gloo ranks of a (1, 2) mesh on cuda:0 -------------------------------
    try:
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "go"), "w"):
            pass
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"spmd (b): rank {r} exited {p.returncode}:\n{text[-3000:]}")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
               for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, g in enumerate(got):
        if g["modules"]:
            fail(f"spmd (b): rank {r} loaded {g['modules'][:5]}")
        if g["launches"] != {"nms": DP_STEPS, "conv1_pool": DP_STEPS, "int8_gemm": 0,
                             "conv1_v5": 0}:
            fail(f"spmd (b): rank {r} launched {g['launches']}")
        if not all(g["held"]["nms"]) or not all(c["ok"] for c in g["held"]["conv1"]) \
                or len(g["held"]["nms"]) != 1 or len(g["held"]["conv1"]) != 1:
            fail(f"spmd (b): rank {r}'s K1 / K2 launches against their plain versions: "
                 f"{g['held']}")
        out["launches"][f"(1, 2) gloo rank {r}, 2 steps"] = g["launches"]
        out["conv1_err"] = max(out["conv1_err"], g["held"]["conv1"][0]["err"])
        out["conv1_share"] = min(out["conv1_share"], g["held"]["conv1"][0]["share"])
    for n, p in got[0]["params"].items():
        for k, v in p.items():
            if not torch.equal(v, got[1]["params"][n][k]):
                fail(f"spmd (b): the ranks' {n}.{k} differ")
    if got[0]["metrics"] != got[1]["metrics"]:
        fail("spmd (b): the ranks' metrics differ")
    worst_m = 0.0
    for s, (gm, rm) in enumerate(zip(got[0]["metrics"], rms)):
        for k, v in rm.items():
            want = float(v)
            if not math.isfinite(gm[k]) or abs(gm[k] - want) > SPMD_TOL * abs(want) + 1e-6:
                fail(f"spmd (b): step {s} {k} {gm[k]} against the one-process {want}")
            worst_m = max(worst_m, abs(gm[k] - want) / max(abs(want), 1e-30))
    worst, equal, share = leaf_errors(got[0]["params"], ref["params"], params,
                                      tag="spmd (b)", tol=SPMD_PARAM_TOL)
    # the float32 run: the halo's forward and backward at phase 21's gate
    for n, p in got[0]["params32"].items():
        for k, v in p.items():
            if not torch.equal(v, got[1]["params32"][n][k]):
                fail(f"spmd (b) float32: the ranks' {n}.{k} differ")
    worst_m32 = 0.0
    for s, (gm, rm) in enumerate(zip(got[0]["metrics32"], rms32)):
        for k, want in rm.items():
            if not math.isfinite(gm[k]) or abs(gm[k] - want) > SPMD_TOL32 * abs(want) + 1e-6:
                fail(f"spmd (b) float32: step {s} {k} {gm[k]} against the one-process {want}")
            worst_m32 = max(worst_m32, abs(gm[k] - want) / max(abs(want), 1e-30))
    worst32, equal32, share32 = leaf_errors(got[0]["params32"], ref32, p0_32,
                                            tag="spmd (b) float32", tol=DP_TOL)
    sa = out["a"]
    out["b"] = {"ms": [g["ms"] for g in got], "split": [g["split"] for g in got],
                "mem": [g["mem"] for g in got], "stats": got[0]["stats"],
                "worst": worst, "bit_equal": equal, "bit_equal_share": share,
                "worst_metric": worst_m, "seconds": ranks_s,
                "float32": {"worst": worst32, "bit_equal_share": share32,
                            "worst_metric": worst_m32,
                            "loss": [got[0]["metrics32"][-1]["loss"], rms32[-1]["loss"]]},
                "mem_sites": [g["mem_sites"] for g in got],
                "loss": [got[0]["metrics"][-1]["loss"], float(rms[-1]["loss"])],
                "k2_shape": got[0]["held"]["conv1"][0]["shape"]}
    sb = out["b"]
    mem_line = "; ".join(
        f"rank {r} peak {gib(m['peak']):.3f} GiB ({gib(m['peak'] - m['before']):.3f} above "
        f"its {gib(m['before']):.3f} before the step)" for r, m in enumerate(sb["mem"]))
    sp = sb["split"][0]
    log(f"spmd (b): two gloo ranks of a (1, 2) mesh on cuda:0, each the 4 images' "
        f"384-row bands (K2 on {sb['k2_shape']}), {DP_STEPS} steps: ranks' params and "
        f"metrics bit-identical; against the one-process step on the whole batch: "
        + ("params bit-equal" if equal else
           f"worst leaf {worst:.3g} of its move (gate {SPMD_PARAM_TOL}), {share:.6f} of the "
           "values bit-equal")
        + f", worst metric {worst_m:.3g} relative (gate {SPMD_TOL}); loss "
        f"{sb['loss'][0]:.5f} / {sb['loss'][1]:.5f}; K1 and K2 held to their plain "
        f"versions in each rank; launches {[g['launches'] for g in got]}")
    s32 = sb["float32"]
    log(f"spmd (b) float32: the same {DP_STEPS} steps in float32 (plain conv1) on both "
        f"ranks: ranks bit-identical; against the one-process float32 step: worst leaf "
        f"{s32['worst']:.3g} of its move (gate {DP_TOL}), {s32['bit_equal_share']:.6f} of "
        f"the values bit-equal, worst metric {s32['worst_metric']:.3g} relative (gate "
        f"{SPMD_TOL32}); loss {s32['loss'][0]:.6f} / {s32['loss'][1]:.6f}")
    log(f"spmd (b) memory: {mem_line}; the one-process step peak "
        f"{gib(sa['mem']['peak']):.3f} GiB ({gib(sa['mem']['peak'] - sa['mem']['before']):.3f}"
        f" above its {gib(sa['mem']['before']):.3f})")
    log(f"spmd (b) memory, the one-process step (allocator history, an untimed step): "
        f"{sites_text(sa['mem_sites'])}")
    for r, ms_ in enumerate(sb["mem_sites"]):
        log(f"spmd (b) memory, rank {r} (allocator history, its first step): "
            f"{sites_text(ms_)}")
    log(f"spmd (b) time: rank step ms {[[round(t, 1) for t in g['ms']] for g in got]} "
        f"(the one-process step {sa['plain_ms']:.1f} ms, median of 3); rank 0's second "
        f"step: halo {sp.get('halo', 0.0):.2f} ms for {sb['stats']['halo_calls']} "
        f"exchanges of {sb['stats']['halo_bytes'] / 1e6:.2f} MB, gather "
        f"{sp.get('gather', 0.0):.2f} ms of {sb['stats']['gather_bytes'] / 1e6:.2f} MB, "
        f"batch leaves {sp.get('batch', 0.0):.2f} ms, all-reduce "
        f"{sp.get('all_reduce', 0.0):.2f} ms; split "
        f"{json.dumps({k: round(v, 2) for k, v in sp.items()})}; the ranks' steps took "
        f"{ranks_s:.1f} s after (a)'s {t_a:.1f} s")
    del got, ref, params, case
    torch.cuda.empty_cache()

    # -- (e) the s2d conv1 route ------------------------------------------------------
    s2d_deploy(dev, counts, zero_counts, out)

    # -- (c) no jax, mscnn_tpu or cv2 -------------------------------------------------
    if reference_modules():
        fail(f"spmd: {reference_modules()[:5]} imported")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"spmd (c): no jax, mscnn_tpu or cv2 module in this process or either rank; "
        f"phase 22 took {out['seconds']:.1f} s"
        + (" (over its 60 s)" if out["seconds"] > 60 else ""))
    return out


# -- phase 23: the example drivers ---------------------------------------------

# (driver, its environment, its arguments, the kernels its path launches:
# each at least once, every other kernel never); profile_stages_8s768 runs
# once a conv1 route, which it reads from MSCNN_CONV1 as the JAX script does
EXAMPLE_RUNS = (
    ("profile_stages_8s768", {}, ["--iters", "1"], ("nms", "conv1_pool")),
    ("profile_stages_8s768", {"MSCNN_CONV1": "plain"}, ["--iters", "1"], ("nms",)),
    ("profile_stages_8s768", {"MSCNN_CONV1": "s2d"}, ["--iters", "1"], ("nms",)),
    ("profile_stages_int8", {}, ["--iters", "1"], ("nms", "int8_gemm")),
    ("profile_int8", {}, ["--iters", "1"], ("nms", "conv1_pool", "int8_gemm")),
    ("profile_batch_stages", {}, ["--iters", "1"], ("nms", "conv1_pool", "int8_gemm")),
    ("profile_batch_scaling", {}, ["--iters", "1"], ("nms", "conv1_pool", "int8_gemm")),
    ("profile_flagship_roi_chunk", {}, ["--iters", "1"], ("nms", "int8_gemm")),
    ("profile_roi_stage", {}, ["--iters", "1"], ()),
    ("profile_roi_batch", {}, ["--iters", "1"], ()),
    ("profile_roi_variants", {}, ["--iters", "1"], ()),
    ("profile_train_step", {}, ["--iters", "1"], ("nms",)),
    ("profile_train_parts", {}, ["--iters", "1"], ("nms",)),
    ("synthetic_e2e", {}, ["--iters", "300", "--eval-images", "8"],
     ("nms", "int8_gemm")),
    ("profile_cascade_roi_chunk", {}, ["--iters", "1"], ("nms",)),
    ("profile_widerface_stages", {}, ["--iters", "1"], ("nms",)),
    ("profile_widerface_budget", {}, ["--iters", "1"], ("nms",)),
)
EXAMPLES_MAX_S = 240.0
KERNEL_KEYS = ("nms", "conv1_pool", "int8_gemm", "conv1_v5")


class InlineHold:
    """Wraps the CUDA launch functions of K1, K2 and K4 so that each launch
    is held at once to its plain version on its own tensors
    (`hold_to_plain`: K1 and K4 equal, K2 by `conv1_compare`) and nothing
    is kept: a driver's loops launch the kernels hundreds of times at full
    width. The errors fold into `out` as `hold_to_plain` folds them; the
    kernels' launch counters still count each launch once (the plain
    versions launch nothing)."""

    def __init__(self, out):
        from mscnn_torch.ops.kernels import conv1_kernel as CK
        from mscnn_torch.ops.kernels import int8_kernel as IK
        from mscnn_torch.ops.kernels import nms_kernel as NK
        self.out, self.tag = out, ""
        self.sites = ((NK, "nms_xywh_cuda", "nms"), (CK, "conv1_pool_cuda", "conv1"),
                      (IK, "int8_conv_cuda", "int8"))
        self.orig = {key: getattr(mod, name) for mod, name, key in self.sites}

    def _wrap(self, key):
        fn = self.orig[key]

        def held(*a, **kw):
            got = fn(*a, **kw)
            sink = {"nms": [], "conv1": [], "int8": []}
            sink[key].append((a, got) if key == "conv1" else (a, kw, got))
            hold_to_plain(sink, self.tag, self.out)
            return got
        return held

    def __call__(self, on, tag=""):
        self.tag = tag
        for mod, name, key in self.sites:
            setattr(mod, name, self._wrap(key) if on else self.orig[key])


def tiny_model_dir(root):
    """A model directory for train_mscnn.sh: 4 seeded 64x96 PPM scenes with
    a bright box each and their window file, and trainval_1st /
    trainval_2nd / solver_1st / solver_2nd of zoo.tiny_test_config()
    (config/zoo_export.py; batch 2, 2 iterations a stage, snapshot
    prefixes s1 / s2 in the directory)."""
    import numpy as np

    from mscnn_torch.config import zoo_export as ZE
    from mscnn_torch.data import window_file as W
    from mscnn_torch.data.augment import AugmentSpec
    from mscnn_torch.data.pipeline import DatasetSpec
    from mscnn_torch.models import zoo
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train.solver import SolverSpec
    from mscnn_torch.train.train_step import TrainSpec

    cfg = zoo.tiny_test_config()
    h, w = cfg.input_hw
    rng = np.random.RandomState(SEED)
    images = []
    for i in range(4):
        img = rng.randint(0, 120, (h, w, 3)).astype(np.uint8)
        img[20:44, 30:58] = 240
        path = os.path.join(root, f"im_{i}.ppm")
        write_ppm(path, img)
        images.append(W.WindowImage(path, 3, h, w, np.array([[1, 0, 30, 20, 58, 44]],
                                                            np.float32),
                                    np.zeros((0, 4), np.float32)))
    wf = os.path.join(root, "windows.txt")
    W.write_window_file(wf, images)
    aug = AugmentSpec(template_hw=cfg.input_hw)
    sspec = SolverSpec(type="sgd", base_lr=5e-5, lr_policy="step", gamma=0.1,
                       stepsize=100, max_iter=2, momentum=0.9, weight_decay=5e-4)
    for stage, tag in ((1, "1st"), (2, "2nd")):
        tspec = TrainSpec(stage=2) if stage == 2 else \
            TrainSpec(stage=1, sample_mode="random", roi_bg_thr_hg=0.5)
        net = os.path.join(root, f"trainval_{tag}.prototxt")
        with open(net, "w") as f:
            f.write(ZE.trainval_prototxt(cfg, tspec, aug, DatasetSpec(batch_size=2),
                                         source=wf))
        lspec = LP.LoopSpec(max_iter=2, display=1,
                            snapshot_prefix=os.path.join(root, f"s{stage}"))
        with open(os.path.join(root, f"solver_{tag}.prototxt"), "w") as f:
            f.write(ZE.solver_prototxt(sspec, lspec, net=net, random_seed=7))


def cli_child_main(argv):
    """One `cli train` call of train_mscnn.sh, run as `chip_smoke.py
    --cli-child OUT -m mscnn_torch.cli train ...` (MSCNN_PYTHON): the
    kernels (built by the parent) launched through `InlineHold`, and a
    JSON record of the call (its arguments, exit code, launches, errors,
    whether jax, mscnn_tpu or cv2 was loaded) appended to OUT/calls.jsonl."""
    out_dir = argv[1]
    if argv[2:4] != ["-m", "mscnn_torch.cli"]:
        fail(f"--cli-child runs `-m mscnn_torch.cli ...`, not {argv[2:]}")
    import torch

    from mscnn_torch import cli
    from mscnn_torch.ops.kernels import build
    from mscnn_torch.ops.kernels import conv1_kernel as CK
    from mscnn_torch.ops.kernels import int8_kernel as IK
    from mscnn_torch.ops.kernels import nms_kernel as NK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    errs = {"nms_err": 0.0, "conv1_err": 0.0, "conv1_share": 1.0, "int8_err": 0.0}
    hold = InlineHold(errs)
    NK.launches = CK.launches = IK.launches = 0
    hold(True, "examples: train_mscnn.sh")
    try:
        rc = cli.main(argv[4:])
    finally:
        hold(False)
    torch.cuda.synchronize()
    rec = {"argv": argv[4:], "rc": rc, "errs": errs,
           "launches": {"nms": NK.launches, "conv1_pool": CK.launches,
                        "int8_gemm": IK.launches},
           "foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "mscnn_tpu", "cv2"))}
    with open(os.path.join(out_dir, "calls.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    sys.exit(rc)


def examples_phase(dev, counts, zero_counts):
    """Phase 23: every example driver of `mscnn_torch/examples/` through its
    `main([...])` at full width and a short run (EXAMPLE_RUNS), then
    `train_mscnn.sh` through bash on a tiny model directory (`train_sh`).
    Each run's launches are read from that run alone and every launch is
    held to its plain version at once (`InlineHold`); the drivers' own
    checks must hold. Returns the phase's figures."""
    import importlib

    import torch

    t_phase = time.perf_counter()
    out = {"launches": {}, "results": {}, "seconds_by_run": {}, "nms_err": 0.0,
           "conv1_err": 0.0, "conv1_share": 1.0, "int8_err": 0.0}
    hold = InlineHold(out)
    for name, env, argv, expect in EXAMPLE_RUNS:
        mod = importlib.import_module(f"mscnn_torch.examples.{name}")
        tag = " ".join([*(f"{k}={v}" for k, v in env.items()), name])
        t0 = time.perf_counter()
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        zero_counts()
        hold(True, f"examples: {tag}")
        try:
            res = mod.main(argv)
        finally:
            hold(False)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        torch.cuda.synchronize()
        got = counts()
        out["seconds_by_run"][tag] = time.perf_counter() - t0
        out["launches"][tag] = got
        out["results"][tag] = res
        check_launched(tag, got, expect)
        bad = examples_check(name, res, env)
        if bad:
            fail(f"examples: {tag}: {bad}")
        log(f"examples: {tag} {' '.join(argv)}: launches {got}, each held to its plain "
            f"version; its checks hold; {out['seconds_by_run'][tag]:.1f} s")
        del res
        torch.cuda.empty_cache()

    train_sh(out)
    if jax_loaded() or "cv2" in sys.modules:
        fail("the examples phase imported jax, mscnn_tpu or cv2")
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > EXAMPLES_MAX_S:
        fail(f"examples: phase 23 took {out['seconds']:.1f} s ({EXAMPLES_MAX_S:.0f} s "
             "at most)")
    log(f"examples: no jax, mscnn_tpu or cv2 module loaded; phase 23 took "
        f"{out['seconds']:.1f} s")
    return out


def check_launched(tag, got, expect):
    """Fail unless the run launched each kernel in `expect` and no other."""
    for k in KERNEL_KEYS:
        if (got[k] > 0) != (k in expect):
            fail(f"examples: {tag} launched {got}, expected exactly {list(expect)}")


def train_sh(out):
    """train_mscnn.sh through bash on `tiny_model_dir` with `--device cuda
    --bf16 --conv1 auto --no-native` (the one-thread input pipeline: the
    worker loader's processes would start for two iterations): each `cli
    train` a child process
    (`cli_child_main`) that holds its own launches; stage 2's `--weights`
    must be stage 1's last snapshot. Folds the children's errors and
    launches into `out`."""
    from mscnn_torch.io import checkpoint as CKPT

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mscnn_train_sh_")
    try:
        tiny_model_dir(root)
        script = os.path.join(REPO, "mscnn_torch", "examples", "train_mscnn.sh")
        env = {**os.environ, "PYTHONPATH": REPO,
               "MSCNN_PYTHON": f"{sys.executable} {os.path.abspath(__file__)} "
                               f"--cli-child {root}"}
        opts = ["--device", "cuda", "--bf16", "--conv1", "auto", "--no-native"]
        run = subprocess.run(["bash", script, root, *opts], env=env, capture_output=True,
                             text=True, timeout=300)
        if run.returncode != 0:
            fail(f"examples: train_mscnn.sh exited {run.returncode}: "
                 f"{(run.stdout + run.stderr)[-2000:]}")
        with open(os.path.join(root, "calls.jsonl")) as f:
            calls = [json.loads(line) for line in f]
        snap1 = CKPT.latest_snapshot(os.path.join(root, "s1"))
        want = [["train", "--solver", "solver_1st.prototxt", *opts],
                ["train", "--solver", "solver_2nd.prototxt", "--weights", snap1, *opts]]
        if [c["argv"] for c in calls] != want or snap1 is None:
            fail(f"examples: train_mscnn.sh ran {[c['argv'] for c in calls]}, expected "
                 f"stage 2 warm-started from stage 1's last snapshot {snap1}")
        for i, c in enumerate(calls):
            if c["rc"] != 0 or c["foreign"]:
                fail(f"examples: train_mscnn.sh call {i + 1}: rc {c['rc']}, loaded "
                     f"{c['foreign']}")
            for k in ("nms_err", "conv1_err", "int8_err"):
                out[k] = max(out[k], c["errs"][k])
            out["conv1_share"] = min(out["conv1_share"], c["errs"]["conv1_share"])
        sh = {k: sum(c["launches"][k] for c in calls) for k in ("nms", "conv1_pool",
                                                                "int8_gemm")}
        sh["conv1_v5"] = 0
        check_launched("train_mscnn.sh", sh, ("nms", "conv1_pool"))
        out["launches"]["train_mscnn.sh"] = sh
        out["launches_sh_calls"] = [c["launches"] for c in calls]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds_by_run"]["train_mscnn.sh"] = time.perf_counter() - t0
    log(f"examples: train_mscnn.sh {' '.join(opts)}: stage 2 "
        f"warm-started from {os.path.basename(snap1)}; launches a call "
        f"{out['launches_sh_calls']}, each held to its plain version in its process; "
        f"{out['seconds_by_run']['train_mscnn.sh']:.1f} s")


def examples_check(name, res, env):
    """The driver's own checks on its result: a message where one fails."""
    def finite(*keys):
        return all(isinstance(res.get(k), (int, float)) and math.isfinite(res[k])
                   for k in keys)

    if name == "profile_stages_8s768":
        if res["conv1"] != env.get("MSCNN_CONV1", "pallas"):
            return f"conv1 routed {res['conv1']!r} under {env}"
        if not finite("full_ms", "full_mfu") or not 0 < res["full_mfu"] < 1:
            return f"full_ms {res.get('full_ms')}, full_mfu {res.get('full_mfu')}"
    elif name == "profile_widerface_stages":
        if res["prebranch_equal"] is not True:
            return "the pre-top-k propose differs from production's"
    elif name == "profile_widerface_budget":
        if res["merged_max_abs_diff_f32"] != 0.0:
            return f"merged heads differ in float32 by {res['merged_max_abs_diff_f32']}"
        err, ref, share = (res["merged_max_abs_diff"], res["merged_max_abs_ref"],
                           res["merged_bit_equal_share"])
        ulps = CONV1_MAX_ULPS * 2.0 ** (math.floor(math.log2(ref)) - 7) if ref > 0 else 0.0
        if not (err <= 0.02 * ref and err <= ulps and share >= CONV1_MIN_SHARE):
            return (f"merged heads differ in bf16 by {err} (max|ref| {ref}, bit-equal "
                    f"share {share}): outside K2's gate")
    elif name == "profile_roi_variants":
        errs = {k: v for k, v in res.items() if k.endswith("_maxerr")}
        if len(errs) != 3 or any(v != 0.0 for v in errs.values()):
            return f"ROI variants differ from production: {errs}"
    elif name == "profile_roi_batch":
        if not all(v["per_image_bit_exact"] is True
                   for k, v in res.items() if k.startswith("b")):
            return "the per-image gathers differ from the batched ones"
    elif name == "profile_roi_stage":
        if res["fc_head_equal"] is not True:
            return "the fc head on the pools differs from M.roi_head"
    elif name == "profile_cascade_roi_chunk":
        if not all(res["chunk_equal"].values()):
            return f"a chunked cascade differs from the unsplit one: {res['chunk_equal']}"
    elif name == "profile_flagship_roi_chunk":
        if not all(r["equal_to_unsplit"] for r in res["runs"]):
            return "a chunked ROI head differs from the unsplit one"
    elif name == "synthetic_e2e":
        aps = list(res["ap"].values()) + list(res["ap_int8"].values())
        if len(aps) != 6 or not all(math.isfinite(a) for a in aps):
            return f"AP not finite: {res['ap']}, int8 {res['ap_int8']}"
    elif name == "profile_train_step":
        if not finite("fwd_loss_ms", "fwd_bwd_ms", "full_step_ms", "pruning_saving_ms"):
            return f"times not finite: {res}"
    return None


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import numpy as np
        import torch.nn.functional as F

        from mscnn_torch import inference as I
        from mscnn_torch.models import mscnn as M
        from mscnn_torch.models import zoo
        from mscnn_torch.ops import conv as C
        from mscnn_torch.ops import nms as nms_ops
        from mscnn_torch.ops import quant as Q
        from mscnn_torch.ops.kernels import build
        from mscnn_torch.examples import profile_conv1 as P1
        from mscnn_torch.examples import profile_conv1_pallas as PP
        from mscnn_torch.examples import profile_conv1_v5 as P5
        from mscnn_torch.examples import profile_int8_mxu as P8
        from mscnn_torch.ops.kernels import conv1_kernel as CK
        from mscnn_torch.ops.kernels import conv1_v5_kernel as K3
        from mscnn_torch.utils import profiling as PROF
        from mscnn_torch.ops.kernels import int8_kernel as IK
        from mscnn_torch.ops.kernels import nms_kernel as NK
        from mscnn_torch.data import synthetic as TSY
        from mscnn_torch.train import solver as TS
        from mscnn_torch.train import train_step as TT
    except ImportError as e:
        fail(f"mscnn_torch not importable ({e}); run from the repository root")
    if jax_loaded():
        fail("the port imported jax or the JAX package")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(info)} "
        + ", ".join(f"{k} {v['seconds']:.1f} s" + (" (cached)" if v["cached"] else "")
                    for k, v in sorted(info.items())))
    for k, v in sorted(info.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", v["log"])]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", v["log"])]
        if regs:
            log(f"  ptxas {k}: {len(regs)} kernel(s), registers {min(regs)}-"
                f"{max(regs)}, spill stores up to {max(spills, default=0)} bytes")

    gen = torch.Generator().manual_seed(SEED)

    def counts():
        return {"nms": NK.launches, "conv1_pool": CK.launches,
                "int8_gemm": IK.launches, "conv1_v5": K3.launches}

    def zero_counts():
        NK.launches = CK.launches = IK.launches = K3.launches = 0

    # -- 2. NMS kernel vs plain ----------------------------------------------
    # the path's two shapes, then the scan's edges in every mode: one box,
    # the largest N, every score equal (index order decides), nothing valid
    nms_cases = [(4, 2000, 256, 0.65, "iou", None), (16, 256, 100, 0.5, "iou", None)] + [
        (p_, n_, mo, 0.5, m, edge) for m in ("iou", "iomu", "iofu")
        for p_, n_, mo, edge in ((3, 300, 64, None), (3, 1, 4, "one box"),
                                 (2, 3072, 300, "N = 3072"), (2, 500, 200, "equal scores"),
                                 (2, 300, 50, "all invalid"))]
    nms_max_err = 0.0
    for p, n, max_out, thr, mode, edge in nms_cases:
        b, s, v = random_candidates(gen, p, n)
        if edge == "equal scores":
            s = torch.full_like(s, 0.25)
        elif edge == "all invalid":
            v = torch.zeros_like(v)
        b, s, v = b.to(dev), s.to(dev), v.to(dev)
        kw = dict(iou_thr=thr, mode=mode, max_out=max_out)
        got = nms_ops.nms_xywh(b, s, v, **kw)
        want = nms_ops.nms_xywh_plain(b, s, v, **kw)
        torch.cuda.synchronize()
        if not nms_equal(got, want):
            fail(f"nms kernel != plain at P={p} N={n} max_out={max_out} {mode}")
        nms_max_err = max(nms_max_err, nms_err(got, want))
        log(f"nms: P={p} N={n} max_out={max_out} thr={thr} {mode}"
            f"{f' ({edge})' if edge else ''}: equal ({int(got[2].sum())} kept)")

    # -- 3. the bias rounding of C.conv2d / C.dense, then K2 vs plain ---------
    # in bf16 with nonzero biases the port rounds as mscnn_tpu/ops/conv.py:
    # the op's output to bf16, then a bf16 add of the bf16 bias; the
    # single-call form (the bias inside F.conv2d / F.linear) is logged beside
    rgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for tag, x_, w_, b_ in (
            ("conv2d conv3_1 [4, 192, 640, 128]",
             torch.randn((4, 192, 640, 128), generator=rgen, device=dev),
             torch.randn((256, 128, 3, 3), generator=rgen, device=dev) * 0.05,
             torch.randn((256,), generator=rgen, device=dev) * 0.5),
            ("dense fc6 [1024, 12800]",
             torch.randn((1024, 12800), generator=rgen, device=dev),
             torch.randn((4096, 12800), generator=rgen, device=dev) * 0.01,
             torch.randn((4096,), generator=rgen, device=dev) * 0.5)):
        x_, w_ = x_.bfloat16(), w_.bfloat16()
        conv = tag.startswith("conv2d")
        got = C.conv2d(x_, w_, b_) if conv else C.dense(x_, w_, b_)
        bare = C.conv2d(x_, w_) if conv else C.dense(x_, w_)
        want = bare + b_.bfloat16()   # bf16 + bf16: the exact sum rounded once
        once = (F.conv2d(x_.permute(0, 3, 1, 2), w_, b_.bfloat16(), padding=1)
                .permute(0, 2, 3, 1) if conv else F.linear(x_, w_, b_.bfloat16()))
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            fail(f"{tag}: the bf16 bias add does not round as the reference "
                 f"(share {(got == want).float().mean().item()})")
        log(f"bias rounding {tag}, bf16, nonzero biases: equal to bf16(bf16(op) + "
            f"bf16(b)) bit for bit; the bias inside the call agrees at "
            f"{(once == want).float().mean().item():.6f} of the outputs")
        del x_, w_, b_, got, bare, want, once
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=True, max_out=256),
                              compute_dtype="bfloat16", pallas_conv1=True)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, device=dev)
    w1_f32 = params["conv1_1"]["w"]   # float32, not bf16-valued
    params = M.cast_params(params, torch.bfloat16)
    log(f"params: {sum(t.numel() for p in params.values() for t in p.values())} "
        f"(seeded random, bf16) in {time.perf_counter() - t0:.1f} s")
    w1, b1 = params["conv1_1"]["w"], params["conv1_1"]["b"]
    w2, b2 = params["conv1_2"]["w"], params["conv1_2"]["b"]
    conv1_max_err = 0.0
    conv1_min_share = 1.0

    def conv1_check(x, tag, w1=w1, b1=b1, b2=b2):
        nonlocal conv1_max_err, conv1_min_share
        got = CK.conv1_pool_fused(x, w1, b1, w2, b2).float()
        want = CK.conv1_pool_plain(x, w1, b1, w2, b2).float()
        torch.cuda.synchronize()
        err, tol, eq, ulps, ok = conv1_compare(got, want)
        log(f"conv1 {tag}: {tuple(x.shape)} max_abs_err {err:.4g} "
            f"(atol {tol:.4g}, {CONV1_MAX_ULPS} ulps of max|ref| {ulps:.4g}, "
            f"max|ref| {want.abs().max().item():.4g}), bit-equal share {eq:.6f} "
            f"(at least {CONV1_MIN_SHARE})")
        if not ok:
            fail(f"conv1 kernel != plain at {tag} {tuple(x.shape)}: max_abs_err "
                 f"{err} (atol {tol}, ulp limit {ulps}), bit-equal share {eq}")
        conv1_max_err = max(conv1_max_err, err)
        conv1_min_share = min(conv1_min_share, eq)
        return want

    H, W = cfg.input_hw
    mean = torch.tensor(MEAN, device=dev)
    imgs = torch.randint(0, 256, (BATCH, H, W, 3), generator=gen,
                         dtype=torch.uint8).to(dev)
    path_x = (imgs.float() - mean).bfloat16()
    conv1_check(path_x, "path shape")
    # float32 w1 on the path's image: the kernel rounds it to bf16 as the
    # plain version does. The control, conv1_1 from the float32 w1 (the
    # earlier wrapper's arithmetic), must fail the gates
    want = conv1_check(path_x, "path shape, float32 w1", w1=w1_f32)
    y1_old = torch.relu(C.conv2d(path_x.float(), w1_f32, b1.float(), padding=1))
    old = C.max_pool(torch.relu(C.conv2d(y1_old.bfloat16(), w2, b2, padding=1)), 2, 2)
    err, tol, eq, ulps, ok = conv1_compare(old.float(), want)
    log(f"conv1 control, conv1_1 from float32 w1 on the path's image: max_abs_err "
        f"{err:.4g} (ulp limit {ulps:.4g}), bit-equal share {eq:.6f}: "
        f"{'passes' if ok else 'fails'} the gates")
    if ok:
        fail("the conv1 gates pass conv1_1 computed from float32 w1")
    del want, y1_old, old
    odd_x = (torch.randn((1, 19, 37, 3), generator=gen) * 50).to(dev).bfloat16()
    conv1_check(odd_x, "odd size")
    # K2's edges: odd sizes at B = 1 and 4, images smaller than one 16 x 32
    # tile, more tiles than CTAs (the persistent loop wraps), W % 8 != 0
    for shape, tag in (((4, 19, 37, 3), "odd size, batch 4"),
                       ((1, 7, 9, 3), "below one tile"),
                       ((4, 200, 330, 3), "tiles wrap the grid"),
                       ((2, 33, 71, 3), "W not a multiple of 8")):
        conv1_check((torch.randn(shape, generator=gen) * 50).to(dev).bfloat16(), tag)
    # nonzero biases (randn * 0.5; init_params gives zeros): the plain
    # version adds them where conv.py does, to the conv's bf16 output in bf16
    bgen = torch.Generator().manual_seed(SEED + 1)
    nb1, nb2 = ((torch.randn(64, generator=bgen) * 0.5).to(dev) for _ in range(2))
    conv1_check(path_x, "path shape, nonzero biases", b1=nb1, b2=nb2)
    # conv1_1 from bf16 weights: w1 = 1 + 2^-8 (halfway between two bf16
    # values), an all-ones input, w2 of small exact values -- every sum exact
    # in f32, so the kernel equals the plain version bit for bit; float32
    # weights (the earlier wrapper's arithmetic) round y1 to 27.125, not 27
    ones = torch.ones((2, 21, 45, 3), device=dev, dtype=torch.bfloat16)
    rw1 = torch.full((64, 3, 3, 3), 1.0 + 2.0 ** -8, device=dev)
    rw2 = (torch.randint(-4, 5, (64, 64, 3, 3), generator=gen).float() / 64).to(dev)
    zb = torch.zeros(64, device=dev)
    got = CK.conv1_pool_fused(ones, rw1, zb, rw2, zb)
    want = CK.conv1_pool_plain(ones, rw1, zb, rw2, zb)
    y1_old = torch.relu(C.conv2d(ones.float(), rw1, zb, padding=1)).bfloat16()
    old = C.max_pool(torch.relu(C.conv2d(y1_old, rw2.bfloat16(), zb, padding=1)), 2, 2)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("conv1 kernel != plain bit for bit on the w1-rounding input")
    log(f"conv1 w1 rounding: kernel == plain bit for bit; float32 w1 gives y1 "
        f"{y1_old[0, 5, 5, 0].item()} and differs at "
        f"{(old != want).float().mean().item():.4f} of the outputs")
    del got, want, y1_old, old

    # -- 3b. K3 (conv1_v5) vs plain: every mode and tile, zero and nonzero
    #        biases, with K2's gate --------------------------------------------
    k3_max_err = 0.0
    k3_min_share = 1.0
    probe_in = P5.make_inputs(dev)   # the probe's x [1, 768, 2560, 3] and weights
    zb = torch.zeros(64, device=dev)
    zero_counts()
    for tag, x in (("probe shape", probe_in[0].bfloat16()), ("odd size", odd_x),
                   ("deploy batch", path_x)):
        kw1, kw2 = (probe_in[1], probe_in[3]) if tag == "probe shape" else (w1, w2)
        for btag, (kb1, kb2) in (("zero biases", (zb, zb)), ("nonzero biases", (nb1, nb2))):
            ws = (kw1, kb1, kw2, kb2)
            outs = {}
            for mode in P5.MODES:
                want = K3.conv1_v5_plain(x, *ws, mode=mode).float()
                for th, tq in K3.TILES:
                    got = K3.conv1_v5_cuda(x, *ws, tile_h=th, tile_q=tq, mode=mode).float()
                    torch.cuda.synchronize()
                    err, tol, eq, ulps, ok = conv1_compare(got, want)
                    log(f"conv1_v5 {mode} {th}x{tq} {tag}, {btag}: {tuple(x.shape)} "
                        f"max_abs_err {err:.4g} (atol {tol:.4g}, ulp limit {ulps:.4g}), "
                        f"bit-equal share {eq:.6f}")
                    if not ok:
                        fail(f"conv1_v5 kernel != plain in mode {mode}, tile {th}x{tq}, "
                             f"at {tag} {tuple(x.shape)} with {btag}: max_abs_err {err} "
                             f"(atol {tol}, ulp limit {ulps}), bit-equal share {eq}")
                    k3_max_err = max(k3_max_err, err)
                    k3_min_share = min(k3_min_share, eq)
                    if (th, tq) == K3.DEFAULT_TILE:
                        outs[mode] = got
                    del got
                del want
            # with zero biases the f32 modes compute K2's function (with
            # nonzero ones K3 adds them in f32, K2 in bf16: another function)
            if btag == "zero biases":
                k2 = CK.conv1_pool_fused(x, *ws).float()
                for mode in ("serial", "mc", "flat"):
                    err, _, eq, _, ok = conv1_compare(outs[mode], k2)
                    log(f"conv1_v5 {mode} {tag}: vs K2's kernel max_abs_err {err:.4g}, "
                        f"bit-equal share {eq:.6f}")
                    if not ok:
                        fail(f"conv1_v5 {mode} != K2's kernel at {tag}: max_abs_err {err}, "
                             f"bit-equal share {eq}")
                del k2
            differ = (outs["bf16"] != outs["serial"]).float().mean().item()
            log(f"conv1_v5 bf16 vs serial {tag}, {btag}: {differ:.4f} of the outputs differ")
            if differ == 0:
                fail(f"conv1_v5 mode bf16 gave mode serial's output at {tag}, {btag}")
            del outs
            torch.cuda.empty_cache()
    k3_phase = K3.launches
    if k3_phase != 3 * 2 * len(P5.MODES) * len(K3.TILES):
        fail(f"the conv1_v5 phase launched K3 {k3_phase} times, expected "
             f"{3 * 2 * len(P5.MODES) * len(K3.TILES)}")
    log(f"conv1_v5: {k3_phase} launches in the phase, every one within the gate "
        f"(lowest bit-equal share {k3_min_share:.6f})")
    torch.cuda.empty_cache()

    # -- 4. int8 kernel vs plain, raw int32 ------------------------------------
    int8_max_err = 0.0
    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_i8(shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=dgen, device=dev,
                             dtype=torch.int8)

    def int8_exact(got, want, what):
        nonlocal int8_max_err
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"int8 kernel gave {got.dtype} {tuple(got.shape)} at {what}, "
                 f"plain {want.dtype} {tuple(want.shape)}")
        g, w = got.reshape(-1), want.reshape(-1)
        step = 1 << 26   # float64 differences, a chunk at a time
        err = max((g[i:i + step].double() - w[i:i + step].double()).abs().max().item()
                  for i in range(0, g.numel(), step))
        int8_max_err = max(int8_max_err, err)
        if err != 0 or not torch.equal(got, want):
            fail(f"int8 kernel != plain at {what}: max_abs_err {err}")

    def int8_same(got, want, what):
        """int8_exact on an output, or on (output, int8 copies) copy by copy."""
        if torch.is_tensor(want):
            return int8_exact(got, want, what)
        int8_exact(got[0], want[0], what)
        if len(got[1]) != len(want[1]):
            fail(f"int8 kernel wrote {len(got[1])} copies at {what}, plain "
                 f"{len(want[1])}")
        for i, (g, w) in enumerate(zip(got[1], want[1])):
            int8_exact(g, w, f"{what}, int8 copy {i}")

    def epilogue_case(xs, ws, pad, copies):
        """Random int8 x / w with the path's epilogue (bf16, ReLU, a bias) and
        `copies` int8 copies (pooled or not; scales 0.125, which puts many
        outputs on .5 ties, and 0.0371)."""
        f = ws[0]
        x, w = rand_i8(xs), rand_i8(ws)
        scales = (torch.rand((f,), generator=dgen, device=dev) * 1e-2 + 1e-4,
                  torch.randn((f,), generator=dgen, device=dev))
        requant = [(torch.tensor(v, device=dev), pooled)
                   for v, pooled in zip((0.125, 0.0371), copies)]
        kw = dict(padding=(pad, pad), out_dtype=torch.bfloat16, relu=True,
                  requant=requant)
        return (x, w, torch.tensor(0.0123, device=dev), *scales), kw

    probe_args = {}
    for name, m, k, f in K4_PROBES:
        x, w = rand_i8((m, k)), rand_i8((f, k), -16, 17)   # the probe's ranges
        int8_exact(IK.mm_int8(x, w), IK.mm_int8_plain(x, w), f"{name} {m}x{k}x{f}")
        probe_args[name] = (x, w)
        log(f"int8 probe {name}: [{m}, {k}] x [{f}, {k}]^T -> int32: equal")
    rois = BATCH * cfg.proposal.max_out
    shapes = int8_shapes(BATCH, H, W, rois)
    for name, xs, ws, pad in shapes:
        x, w = rand_i8(xs), rand_i8(ws)
        int8_exact(IK.int8_conv(x, w, padding=(pad, pad)),
                   IK.int8_conv_plain(x, w, padding=(pad, pad)), f"{name} {xs}")
        log(f"int8 shape {name}: x {xs} w {ws} pad {pad} -> int32: equal")
        del x, w
        a, kw = epilogue_case(xs, ws, pad, COPIES.get(name, ()))
        int8_same(IK.int8_conv(*a, **kw), IK.int8_conv_plain(*a, **kw),
                  f"{name} {xs} epilogue")
        log(f"int8 shape {name}: bf16 + ReLU + {len(kw['requant'])} int8 copies "
            f"(pooled {COPIES.get(name, ())}): equal")
        del a, kw
        torch.cuda.empty_cache()
    for xs, f, pad, copies in K4_EDGES:
        a, kw = epilogue_case(xs, (f, 3, 3, xs[3]), pad, copies)
        int8_same(IK.int8_conv(*a, **kw), IK.int8_conv_plain(*a, **kw),
                  f"edge case x {xs} F {f}")
        log(f"int8 edge case: x {xs} F {f} pad {pad} copies {copies}: equal")
    torch.cuda.empty_cache()

    # -- 5. deploy main path (bf16) ---------------------------------------------
    ratios = torch.ones((BATCH, 2))
    orig_wh = torch.tensor([[float(W), float(H)]] * BATCH)
    fwd = I.make_e2e_forward(params, cfg, I.DetectSpec(), mean_values=MEAN)
    sink = calls = {"nms": [], "conv1": [], "int8": []}
    nms_cuda, conv1_cuda, int8_cuda = NK.nms_xywh_cuda, CK.conv1_pool_cuda, \
        IK.int8_conv_cuda

    def rec_nms(*a, **kw):
        out = nms_cuda(*a, **kw)
        sink["nms"].append((a, kw, out))
        return out

    def rec_conv1(*a):
        out = conv1_cuda(*a)
        sink["conv1"].append((a, out))
        return out

    def rec_int8(*a, **kw):
        out = int8_cuda(*a, **kw)
        sink["int8"].append((a, kw, out))
        return out

    quantize_act = Q.quantize_act
    quantized = []   # the inputs quantize_act was given in the recorded run

    def rec_quantize(x, x_scale):
        quantized.append((x, x_scale))
        return quantize_act(x, x_scale)

    def recording(on):
        if on:
            NK.nms_xywh_cuda, CK.conv1_pool_cuda, IK.int8_conv_cuda = \
                rec_nms, rec_conv1, rec_int8
            Q.quantize_act = rec_quantize
            quantized.clear()
        else:
            NK.nms_xywh_cuda, CK.conv1_pool_cuda, IK.int8_conv_cuda = \
                nms_cuda, conv1_cuda, int8_cuda
            Q.quantize_act = quantize_act

    recording(True)
    zero_counts()
    t0 = time.perf_counter()
    out = fwd(params, imgs, ratios, orig_wh)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts()
    recording(False)
    log(f"deploy: first call {first_s:.2f} s, launches {launches}")

    check_deploy_out(out, cfg, BATCH)
    nc = cfg.num_classes
    if launches["conv1_pool"] < 1 or launches["nms"] < 2:
        fail(f"the main path did not launch every kernel: {launches}")
    problems = sorted(a[0].shape[0] for a, _, _ in calls["nms"])
    if problems != sorted([BATCH, BATCH * (nc - 1)]):
        fail(f"nms launches covered problems {problems}, "
             f"expected {BATCH} + {BATCH * (nc - 1)}")
    log(f"deploy: {int(out['roi_valid'].sum())} proposals, "
        f"{int(out['valid'].sum())} detections over {BATCH} images")
    lines, first = check_kitti(I, out, BATCH)
    log(f"kitti: {BATCH} label files, {lines} lines, first: {first or '(none)'}")

    # the kernels against their plain versions on the main path's tensors
    for a, kw, got in calls["nms"]:
        want = nms_ops.nms_xywh_plain(*a, **kw)
        if not nms_equal(got, want):
            fail(f"nms kernel != plain on the main path's P={a[0].shape[0]} "
                 f"N={a[0].shape[1]} candidates")
        nms_max_err = max(nms_max_err, nms_err(got, want))
        log(f"nms on path: P={a[0].shape[0]} N={a[0].shape[1]} "
            f"max_out={kw['max_out']}: equal")
    for a, got in calls["conv1"]:
        want = CK.conv1_pool_plain(*a).float()
        err, tol, eq, ulps, ok = conv1_compare(got.float(), want)
        log(f"conv1 on path: {tuple(a[0].shape)} max_abs_err {err:.4g} "
            f"(atol {tol:.4g}, ulp limit {ulps:.4g}), bit-equal share {eq:.6f}")
        if not ok:
            fail(f"conv1 kernel != plain on the main path's batch: max_abs_err "
                 f"{err}, bit-equal share {eq}")
        conv1_max_err = max(conv1_max_err, err)
        conv1_min_share = min(conv1_min_share, eq)

    # a small input against the CPU (plain kernels), float32
    tiny = zoo.tiny_test_config()
    tp = M.init_params(torch.Generator().manual_seed(SEED), tiny, device="cpu")
    timg = torch.randint(0, 256, (2, *tiny.input_hw, 3),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.uint8)
    tx = timg.float() - torch.tensor(MEAN)
    with torch.inference_mode():
        ref = M.deploy_forward(tp, tx, tiny)
        dp = {k: {n: t.to(dev) for n, t in p.items()} for k, p in tp.items()}
        got = M.deploy_forward(dp, tx.to(dev), tiny)
    if not torch.equal(got["roi_valid"].cpu(), ref["roi_valid"]):
        fail("tiny config: proposal valid flags differ between card and CPU")
    for k in ("rois", "cls_pred", "bbox_pred"):
        # f32 with TF32 off: only the summation order differs
        if not torch.allclose(got[k].cpu(), ref[k], rtol=1e-4, atol=1e-3):
            err = (got[k].cpu() - ref[k]).abs().max().item()
            fail(f"tiny config: {k} differs between card and CPU ({err})")
    log("tiny config: card agrees with the CPU plain path")

    # -- 6. int8 deploy path ---------------------------------------------------
    cfg8 = dataclasses.replace(cfg, pallas_conv1=False, int8_trunk=True,
                               int8_roi_head=True)
    cfg8t = dataclasses.replace(cfg8, int8_roi_head=False)   # bench.py's default
    t0 = time.perf_counter()
    p32 = M.init_params(torch.Generator().manual_seed(SEED), cfg8, device=dev)
    cal = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32) * 40.0
    q32, scales, hscales = calibrate_int8(Q, p32, cfg8, cal)
    params8 = M.cast_params(q32, torch.bfloat16)
    del p32, q32
    torch.cuda.empty_cache()
    log(f"int8 calibration: {len(scales)} trunk layers + {sorted(hscales)} in "
        f"{time.perf_counter() - t0:.1f} s; x_s conv1_1 {scales['conv1_1']:.5g}, "
        f"conv3_3 {scales['conv3_3']:.5g}, roi_c1 {hscales['roi_c1']:.5g}, "
        f"fc6 {hscales['fc6']:.5g}")
    fwd8 = I.make_e2e_forward(params8, cfg8, I.DetectSpec(), mean_values=MEAN)
    sink = calls8 = {"nms": [], "conv1": [], "int8": []}
    recording(True)
    zero_counts()
    t0 = time.perf_counter()
    out8 = fwd8(params8, imgs, ratios, orig_wh)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches8 = counts()
    recording(False)
    log(f"deploy int8: first call {first_s:.2f} s, launches {launches8}")
    check_deploy_out(out8, cfg8, BATCH)
    if launches8["int8_gemm"] != len(INT8_LAYERS) or launches8["nms"] != 2 \
            or launches8["conv1_pool"] != 0:
        fail(f"the int8 path launched {launches8}, expected 17 int8, 2 nms, "
             f"0 conv1")
    problems = sorted(a[0].shape[0] for a, _, _ in calls8["nms"])
    if problems != sorted([BATCH, BATCH * (nc - 1)]):
        fail(f"int8 path: nms launches covered problems {problems}")
    got_shapes = [(tuple(a[0].shape), tuple(a[1].shape), kw["padding"][0])
                  for a, kw, _ in calls8["int8"]]
    if got_shapes != [(xs, ws, pad) for _, xs, ws, pad in shapes]:
        fail(f"int8 launches had shapes {got_shapes}")
    got_copies = {name: tuple(p for _, p in kw["requant"])
                  for name, (_, kw, _) in zip(INT8_LAYERS, calls8["int8"])
                  if kw["requant"]}
    if got_copies != COPIES:
        fail(f"int8 launches wrote the copies {got_copies}, expected {COPIES}")
    rois_in = (rois, 7, 7, 1024)
    quantized8 = list(quantized)
    if [tuple(x.shape) for x, _ in quantized8] != [(BATCH, H, W, 3), rois_in]:
        fail(f"quantize_act ran on {[tuple(x.shape) for x, _ in quantized8]} in an "
             f"int8 trunk + heads step, expected the image and the ROI gathers")
    log(f"deploy int8: {int(out8['roi_valid'].sum())} proposals, "
        f"{int(out8['valid'].sum())} detections over {BATCH} images")
    lines, first = check_kitti(I, out8, BATCH)
    log(f"kitti int8: {BATCH} label files, {lines} lines, first: {first or '(none)'}")
    for name, (a, kw, got) in zip(INT8_LAYERS, calls8["int8"]):
        int8_same(got, IK.int8_conv_plain(*a, **kw), f"{name} on the int8 path")
        log(f"int8 on path: {name} x {tuple(a[0].shape)} -> "
            f"{(got if torch.is_tensor(got) else got[0]).dtype} relu={kw['relu']}, "
            f"{len(kw['requant'])} int8 copies: equal")
    # the int8 trunk alone (bench.py's default) quantizes the image only
    sink = {"nms": [], "conv1": [], "int8": []}
    recording(True)
    with torch.inference_mode():
        M.trunk(params8, imgs.float() - mean, cfg8t)
    recording(False)
    if [tuple(x.shape) for x, _ in quantized] != [(BATCH, H, W, 3)] or \
            len(sink["int8"]) != 15:
        fail(f"the int8 trunk quantized {[tuple(x.shape) for x, _ in quantized]} "
             f"and launched K4 {len(sink['int8'])} times")
    sink = calls8
    log(f"quantize_act a step: {len(quantized8)} with the int8 heads (the image, "
        f"the ROI gathers), 1 on the int8 trunk alone (the image)")
    for a, kw, got in calls8["nms"]:
        want = nms_ops.nms_xywh_plain(*a, **kw)
        if not nms_equal(got, want):
            fail(f"nms kernel != plain on the int8 path's P={a[0].shape[0]}")
    log("nms on the int8 path: equal")
    # the int8 layers make no host sync: the int8 trunk, and roi_c1 + fc6 on
    # the path's own inputs, under PyTorch's sync debug mode
    (ra, rkw, _), (fa, fkw, _) = calls8["int8"][-2:]
    qx, qs = quantized8[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            M.trunk(params8, imgs.float() - mean, cfg8)
            Q.quantize_act(qx, qs)
            int8_cuda(*ra, **rkw)
            int8_cuda(*fa, **fkw)
    except RuntimeError as e:
        fail(f"the int8 path synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("int8 trunk and ROI-head layers: no host sync (sync debug mode 'error')")

    # the tiny int8 config on the card and on the CPU (plain kernels)
    tcal = np.random.RandomState(0).randn(1, *tiny.input_hw, 3).astype(np.float32) * 40
    tiny8 = dataclasses.replace(tiny, int8_trunk=True, int8_roi_head=True)
    tq, _, _ = calibrate_int8(Q, tp, tiny8, tcal)
    dq = {k: {n: t.to(dev) for n, t in p.items()} for k, p in tq.items()}
    with torch.inference_mode():
        fref = M.trunk(tq, tx, tiny8)
        fgot = M.trunk(dq, tx.to(dev), tiny8)
        ref = M.deploy_forward(tq, tx, tiny8)
        got = M.deploy_forward(dq, tx.to(dev), tiny8)
    for k in fref:
        if not torch.equal(fgot[k].cpu(), fref[k]):
            err = (fgot[k].cpu() - fref[k]).abs().max().item()
            fail(f"tiny int8 config: trunk feature {k} differs between card and "
                 f"CPU ({err})")
    if not torch.equal(got["roi_valid"].cpu(), ref["roi_valid"]):
        fail("tiny int8 config: proposal valid flags differ between card and CPU")
    if not torch.allclose(got["rois"].cpu(), ref["rois"], rtol=1e-4, atol=1e-3):
        fail("tiny int8 config: rois differ between card and CPU")
    # The int8 ROI head on the CPU's own upsampled map and rois: its only
    # inexact step is then the float cls/bbox dense (f32 tolerance).
    with torch.inference_mode():
        feat = M.upsampled_roi_feature(tq, fref["conv4_3"], tiny8)
        hargs = (ref["batch_idx"], ref["rois"], ref["roi_valid"])
        want = M.roi_head(tq, None, *hargs, tiny8, feat=feat)
        have = M.roi_head(dq, None, *(a.to(dev) for a in hargs), tiny8,
                          feat=feat.to(dev))
    for k, g_, w_ in zip(("cls_pred", "bbox_pred"), have, want):
        if not torch.allclose(g_.cpu(), w_, rtol=1e-4, atol=1e-3):
            err = (g_.cpu() - w_).abs().max().item()
            fail(f"tiny int8 config: ROI head {k} differs between card and CPU "
                 f"on the same inputs ({err})")
    # End to end, the 2x upsample (float) sums in another order on the card;
    # an ulp there can move roi_c1's quantized input by one step, which the
    # int8 head carries to cls/bbox (0.0072 of max|cls| 8.3 when the CPU
    # recomputes only the upsample in float64): 1% of max|ref|.
    errs = {}
    for k in ("cls_pred", "bbox_pred"):
        errs[k] = (got[k].cpu() - ref[k]).abs().max().item()
        if errs[k] > 0.01 * ref[k].abs().max().item():
            fail(f"tiny int8 config: {k} differs between card and CPU ({errs[k]})")
    log(f"tiny int8 config: {len(fref)} trunk features bit-equal between card and "
        f"CPU; ROI head equal to f32 tolerance on the same inputs; end to end "
        f"max abs err cls {errs['cls_pred']:.4g}, bbox {errs['bbox_pred']:.4g}")
    del tq, dq, fref, fgot, feat

    # -- 7. timing ---------------------------------------------------------------
    kernels_ms = {}
    (pa, pkw, _), (qa, qkw, _) = sorted(calls["nms"], key=lambda c: c[0][0].shape[1],
                                        reverse=True)
    for tag, a, kw in (("propose", pa, pkw), ("postprocess", qa, qkw)):
        k_ms = cuda_ms(lambda: nms_cuda(*a, **kw), iters=20)
        d_ms = graph_ms(lambda: nms_cuda(*a, **kw))
        p_ms = cuda_ms(lambda: nms_ops.nms_xywh_plain(*a, **kw), iters=5)
        kernels_ms[f"nms_{tag}"] = (k_ms, p_ms, d_ms)
        log(f"time nms {tag} P={a[0].shape[0]} N={a[0].shape[1]} "
            f"max_out={kw['max_out']}: kernel {k_ms:.4f} ms a call (CUDA events "
            f"around one call, host enqueue included), {d_ms:.4f} ms on the device "
            f"(CUDA graph replay), plain {p_ms:.4f} ms")
    # K1's bound: the bytes of its inputs and outputs, against the steps this
    # run's data needs (one per kept box: an IoU row over N candidates, ~16
    # f32 operations a candidate, on the CUDA cores; the scan tests fewer)
    pout = max(calls["nms"], key=lambda c: c[0][0].shape[1])[2]
    nms_bytes = sum(t.numel() * t.element_size() for t in (*pa, *pout))
    nms_opcount = 16 * int(pout[2].sum()) * pa[0].shape[1]
    nms_bound = bound(nms_bytes, nms_opcount, PEAK["f32"])
    ca = calls["conv1"][0][0]
    k_ms = cuda_ms(lambda: conv1_cuda(*ca), iters=10)
    p_ms = cuda_ms(lambda: CK.conv1_pool_plain(*ca), iters=10)
    kernels_ms["conv1"] = (k_ms, p_ms)
    conv1_bound = conv1_block_bound(ca[0])
    log(f"time conv1 {tuple(ca[0].shape)}: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {conv1_bound[0]:.4f} ms ({conv1_bound[1]})")

    int_mm = {}   # torch._int_mm beside K4 on the same int8 inputs (a yardstick)

    def time_int_mm(name, x, w):
        """K4 (raw int32) and torch._int_mm on x [M, K] x w [F, K] int8."""
        m, k = x.shape
        f = w.shape[0]
        wt = w.t().contiguous()
        k_ms = cuda_ms(lambda: int8_cuda(x.view(m, 1, 1, k), w.view(f, 1, 1, k)),
                       iters=20)
        l_ms = cuda_ms(lambda: torch._int_mm(x, wt), iters=20)
        same = torch.equal(torch._int_mm(x, wt), IK.mm_int8(x, w))
        int_mm[name] = {"shape": [m, k, f], "kernel_ms": k_ms, "int_mm_ms": l_ms}
        log(f"time int8 {name} {m}x{k}x{f} -> int32: kernel {k_ms:.4f} ms, "
            f"torch._int_mm {l_ms:.4f} ms ({'equal' if same else 'NOT equal'})")
        return k_ms

    for name, m, k, f in K4_PROBES:
        x, w = probe_args.pop(name)
        xb, wb = x.bfloat16(), w.t().contiguous().bfloat16()
        k_ms = time_int_mm(f"probe {name}", x, w)
        p_ms = cuda_ms(lambda: IK.mm_int8_plain(x, w), iters=3, warmup=1)
        b_ms = cuda_ms(lambda: torch.matmul(xb, wb), iters=20)
        log(f"time int8 probe {name} {m}x{k}x{f}: kernel {k_ms:.4f} ms "
            f"({2 * m * k * f / k_ms / 1e9:.1f} TOP/s), exact plain {p_ms:.4f} ms, "
            f"bf16 matmul {b_ms:.4f} ms")
        del x, w, xb, wb

    def im2col(xq, kh, kw, pad):
        """[B, H, W, C] int8 -> [M, K] in the weight's (dy, dx, c) order, K
        zero-padded to a multiple of 8 (torch._int_mm's contract)."""
        B_, h_, w_, c_ = xq.shape
        oh, ow = h_ + 2 * pad - kh + 1, w_ + 2 * pad - kw + 1
        xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
        cols = torch.cat([xp[:, dy:dy + oh, dx:dx + ow, :] for dy in range(kh)
                          for dx in range(kw)], -1).reshape(B_ * oh * ow, -1)
        return F.pad(cols, (0, -cols.shape[1] % 8))

    layer_ms = {}
    k4_bound = {"bytes": 0.0, "operations": 0.0}   # ms, summed over the step
    for name, (a, kw, got) in zip(INT8_LAYERS, calls8["int8"]):
        xq, wq = a[0], a[1]
        B_, h_, w_, c_ = xq.shape
        f_, kh_, kw_, _ = wq.shape
        pad = kw["padding"]
        outs = [got] if torch.is_tensor(got) else [got[0], *got[1]]
        k_ms = cuda_ms(lambda: int8_cuda(*a, **kw), iters=10)
        p_ms = cuda_ms(lambda: IK.int8_conv_plain(*a, **kw), iters=2, warmup=1)
        x2d = im2col(xq, kh_, kw_, pad[0])
        w2d = F.pad(wq.reshape(f_, -1), (0, x2d.shape[1] - kh_ * kw_ * c_))
        time_int_mm(name, x2d, w2d)
        del x2d, w2d
        xr = torch.randn(tuple(xq.shape), generator=dgen, device=dev,
                         dtype=torch.bfloat16)
        bw = torch.randn((f_, c_, kh_, kw_), generator=dgen, device=dev,
                         dtype=torch.bfloat16) * 0.01
        bb = torch.zeros((f_,), device=dev, dtype=torch.bfloat16)
        if name == "fc6":
            x2, w2d = xr.view(B_, c_), bw.view(f_, c_)
            b_ms = cuda_ms(lambda: torch.relu(F.linear(x2, w2d, bb)), iters=10)
        else:
            b_ms = cuda_ms(lambda: torch.relu(C.conv2d(xr, bw, bb, padding=pad[0])),
                           iters=10)
        mkf = B_ * (h_ + 2 * pad[0] - kh_ + 1) * (w_ + 2 * pad[1] - kw_ + 1) \
            * kh_ * kw_ * c_ * f_
        moved = sum(t.numel() * t.element_size() for t in (*a, *outs)
                    if torch.is_tensor(t))
        ms_b, ms_o = moved / HBM_BPS * 1e3, 2 * mkf / PEAK["int8"] * 1e3
        k4_bound["bytes" if ms_b >= ms_o else "operations"] += max(ms_b, ms_o)
        layer_ms[name] = {"kernel": k_ms, "plain": p_ms, "bf16_cudnn": b_ms,
                          "int_mm_im2col": int_mm[name]["int_mm_ms"],
                          "bound": max(ms_b, ms_o), "gmac": mkf / 1e9,
                          "copies": len(outs) - 1}
        log(f"time int8 {name} x {tuple(xq.shape)} F {f_}: kernel {k_ms:.4f} ms "
            f"({2 * mkf / k_ms / 1e9:.1f} TOP/s, {ms_o / k_ms:.3f} of the int8 peak; "
            f"{len(outs) - 1} int8 copies), bound {max(ms_b, ms_o):.4f} ms, bf16 "
            f"cuDNN {b_ms:.4f} ms, torch._int_mm on im2col "
            f"{int_mm[name]['int_mm_ms']:.4f} ms, exact plain {p_ms:.4f} ms")
        del xr, bw, bb
    pool_ms = 0.0
    for name, (a, kw, got) in zip(INT8_LAYERS, calls8["int8"]):
        if name in POOL_INPUTS:
            y = got if torch.is_tensor(got) else got[0]
            pool_ms += cuda_ms(lambda: C.max_pool(y, 2, 2), iters=10)
    # the quantize passes left in a step: the image (conv1_1's input) and
    # the ROI gathers (roi_c1's), on the run's own tensors
    quantize_ms = [cuda_ms(lambda: Q.quantize_act(x, x_s), iters=10)
                   for x, x_s in quantized8]
    trunk_layers = INT8_LAYERS[:15]
    split = {"kernels": sum(layer_ms[n]["kernel"] for n in trunk_layers),
             "quantize": quantize_ms[0], "pools": pool_ms,
             "bf16_cudnn_same_shapes": sum(layer_ms[n]["bf16_cudnn"]
                                           for n in trunk_layers),
             "quantize_roi_c1": quantize_ms[1]}
    log("int8_trunk_split_ms " + json.dumps(split))
    int8_ms = sum(v["kernel"] for v in layer_ms.values())
    int8_plain_ms = sum(v["plain"] for v in layer_ms.values())
    log("int8_layers_ms " + json.dumps(layer_ms))
    del calls, calls8, sink, quantized8
    torch.cuda.empty_cache()

    # PTQ quality, informational: on the batch (uniform uint8 pixels, another
    # distribution than the Gaussian calibration image) and on the
    # calibration image itself
    for tag, x_img in (("batch", imgs.float() - mean),
                       ("calibration image", torch.from_numpy(cal).to(dev))):
        with torch.inference_mode():
            fq = M.trunk(params8, x_img, cfg8)
            fb = M.trunk(params8, x_img, dataclasses.replace(cfg8, int8_trunk=False))
        for blob in ("conv3_3", "conv5_3"):
            a_, b_ = fb[blob].float(), fq[blob].float()
            rel = ((a_ - b_).abs().mean() / a_.abs().mean().clamp_min(1e-9)).item()
            log(f"int8 vs bf16 trunk {blob} on the {tag}: mean rel err {rel:.4f} "
                f"(informational)")
        del fq, fb, x_img

    runs = {}
    for tag, p_, c_ in (("bf16", params, cfg), ("int8_trunk", params8, cfg8t),
                        ("int8_trunk_heads", params8, cfg8)):
        stages = stage_breakdown(M, I, p_, c_, imgs, mean, ratios, orig_wh)
        f_ = I.make_e2e_forward(p_, c_, I.DetectSpec(), mean_values=MEAN)
        step, peak_gib = deploy_step(f_, p_, imgs, ratios, orig_wh)
        runs[tag] = (stages, step)
        log(f"stages_ms {tag} " + json.dumps(stages))
        log(f"deploy {tag}: batch {BATCH} at {H}x{W}: median {step * 1e3:.2f} ms/step "
            f"over 5 steps, {BATCH / step:.3f} img/s, peak {peak_gib:.2f} GiB")

    # -- 8. conv1 probes: K3 beside K2, the plain block and cuDNN unfused -------
    default_mode = "mc"
    th0, tq0 = K3.DEFAULT_TILE
    k3 = {}
    for tag, x, ws in (("1x768x2560", probe_in[0].bfloat16(), probe_in[1:]),
                       ("4x768x2560", (imgs.float() - mean).bfloat16(),
                        (w1, b1, w2, b2))):
        r = k3[tag] = {"kernel": {}, "plain": {}, "bound": conv1_block_bound(x)}
        r["plain_block"] = cuda_ms(lambda: CK.conv1_pool_plain(x, *ws), iters=5)
        k2_before = cuda_ms(lambda: CK.conv1_pool_cuda(x, *ws), iters=10)
        for mode in (P5.MODES if tag.startswith("1x") else (default_mode,)):
            r["plain"][mode] = cuda_ms(lambda: K3.conv1_v5_plain(x, *ws, mode=mode),
                                       iters=3, warmup=1)
        for mode in P5.MODES:
            for th, tq in K3.TILES:
                r["kernel"][f"{mode}_{th}x{tq}"] = cuda_ms(
                    lambda: K3.conv1_v5_cuda(x, *ws, tile_h=th, tile_q=tq, mode=mode),
                    iters=10)
        k2_after = cuda_ms(lambda: CK.conv1_pool_cuda(x, *ws), iters=10)
        r["k2"] = (k2_before + k2_after) / 2
        wb1, wb2 = ws[0].bfloat16(), ws[2].bfloat16()
        y1 = torch.relu(C.conv2d(x, wb1, ws[1], padding=1))
        y2 = torch.relu(C.conv2d(y1, wb2, ws[3], padding=1))
        r["cudnn"] = {
            "conv1_1": cuda_ms(lambda: torch.relu(C.conv2d(x, wb1, ws[1], padding=1)),
                               iters=10),
            "conv1_2": cuda_ms(lambda: torch.relu(C.conv2d(y1, wb2, ws[3], padding=1)),
                               iters=10),
            "pool1": cuda_ms(lambda: C.max_pool(y2, 2, 2), iters=10)}
        del y1, y2
        best = min(r["kernel"], key=r["kernel"].get)
        r["k3_best"] = (best, r["kernel"][best])
        log(f"time conv1 probes {tag}: K2 (redesigned) {k2_before:.4f} / "
            f"{k2_after:.4f} ms (before / after K3): "
            f"{'faster' if r['k2'] < r['kernel'][best] else 'NOT faster'} than K3's "
            f"best tile; plain block {r['plain_block']:.4f} ms, cuDNN "
            f"unfused " + ", ".join(f"{k} {v:.4f}" for k, v in r["cudnn"].items())
            + f" ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); K3 best {best} "
            f"{r['kernel'][best]:.4f} ms")
        for mode in P5.MODES:
            log(f"time conv1_v5 {tag} {mode}: " + ", ".join(
                f"{th}x{tq} {r['kernel'][f'{mode}_{th}x{tq}']:.4f}" for th, tq in K3.TILES)
                + " ms" + (f"; plain {r['plain'][mode]:.4f} ms" if mode in r["plain"]
                           else ""))
    torch.cuda.empty_cache()

    # K3's own path: the conv1 probe entry point, counts read from it alone
    zero_counts()
    probe = P5.main([])
    probe_launches = counts()
    log(f"profile_conv1_v5 path: launches {probe_launches}")
    if probe_launches["conv1_v5"] < len(P5.MODES) or probe_launches["conv1_pool"] < 1:
        fail(f"the conv1 probe did not launch K3 in every mode and K2: "
             f"{probe_launches}")
    for mode in P5.MODES:
        if not probe[f"v5_{mode}_relerr"] < 0.05 or \
                not math.isfinite(probe.get(f"v5_{mode}_ms", float("nan"))):
            fail(f"the conv1 probe rejected or did not time mode {mode}: {probe}")
    P1.main()
    PP.main()

    # K4's own probe path, counts read from it alone
    torch.cuda.empty_cache()
    zero_counts()
    probe8 = P8.main()
    probe8_launches = counts()
    log(f"profile_int8_mxu path: launches {probe8_launches}")
    if probe8_launches["int8_gemm"] < len(P8.CONV_SHAPES) + len(P8.MM_CASES):
        fail(f"the int8 probe did not launch K4 at every shape: {probe8_launches}")
    if not all(r["int8_bit_exact"] for r in probe8["convs"]) or \
            not all(r["k4_bit_exact"] for r in probe8["matmuls"]):
        fail(f"the int8 probe found K4 inexact: {probe8}")

    # -- 9. one profiler window over two bf16 deploy steps -----------------------
    fwd(params, imgs, ratios, orig_wh)
    torch.cuda.synchronize()
    trace_window(PROF, lambda: fwd(params, imgs, ratios, orig_wh), "deploy_step",
                 "two bf16 deploy steps", "the step times above are host-clock times")

    # -- 10. K2's backward on the card: the autograd function's gradients
    #        against conv1_pool_plain's under autograd (the same ops) --------
    TH, TW = zoo.kitti_car_8s_768(deploy=False).input_hw   # the training crop
    bgen = torch.Generator().manual_seed(SEED + 7)
    k2b = {}
    for shape in ((2, 64, 96, 3), (BATCH, TH, TW, 3)):
        ins = ((torch.randn(shape, generator=bgen) * 50).to(dev).bfloat16(),
               (torch.randn((64, 3, 3, 3), generator=bgen) * 0.2).to(dev),
               (torch.randn(64, generator=bgen) * 0.5).to(dev),
               (torch.randn((64, 64, 3, 3), generator=bgen) * 0.05).to(dev),
               (torch.randn(64, generator=bgen) * 0.5).to(dev))
        ins = tuple(t.requires_grad_() for t in ins)
        B_, H_, W_, _ = shape
        g = torch.randn((B_, (H_ + 1) // 2, (W_ + 1) // 2, 64), generator=bgen)
        g = g.to(dev).bfloat16()
        before = CK.launches
        y = CK.conv1_pool_fused(*ins)
        if CK.launches != before + 1:
            fail("conv1_pool_fused with inputs that require grad did not launch K2")
        y_plain = CK.conv1_pool_plain(*ins)
        err, tol, eq, ulps, ok = conv1_compare(y.detach().float(), y_plain.detach().float())
        if not ok:
            fail(f"K2 forward (requires grad) != plain at {shape}: max_abs_err {err}, "
                 f"bit-equal share {eq}")
        got = torch.autograd.grad(y, ins, g, retain_graph=True)
        want = torch.autograd.grad(y_plain, ins, g, retain_graph=True)
        worst = 0.0
        for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
            ref = b.float().abs().max().item()
            e = (a.float() - b.float()).abs().max().item()
            worst = max(worst, e / ref if ref else e)
            if a.shape != b.shape or a.dtype != b.dtype or e > 1e-6 * ref:
                fail(f"K2 backward: grad {name} at {shape} differs from "
                     f"conv1_pool_plain's ({e} against max|ref| {ref})")
        log(f"conv1 backward {shape}: forward max_abs_err {err:.4g} (share {eq:.6f}); "
            f"grads x, w1, b1, w2, b2 within {worst:.3g} of max|ref| of "
            f"conv1_pool_plain's under autograd")
        k2b[shape] = (ins, y, y_plain, g)
    ins, y, y_plain, g = k2b[(BATCH, TH, TW, 3)]
    k2b_ms = cuda_ms(lambda: torch.autograd.grad(y, ins, g, retain_graph=True), iters=5)
    k2b_plain_ms = cuda_ms(lambda: torch.autograd.grad(y_plain, ins, g, retain_graph=True),
                           iters=5)
    k2_fb_ms = cuda_ms(lambda: torch.autograd.grad(CK.conv1_pool_fused(*ins), ins, g),
                       iters=5)
    plain_fb_ms = cuda_ms(lambda: torch.autograd.grad(CK.conv1_pool_plain(*ins), ins, g),
                          iters=5)
    # the backward recomputes the block (77,184 FLOP a pixel) and takes
    # conv1_2's dgrad and wgrad (2 x 73,728) and conv1_1's (2 x 3,456)
    xb = ins[0]
    moved = 2 * xb.numel() * 2 + g.numel() * 2
    k2b_bound = bound(moved, (CONV1_FLOP_PER_PIXEL + 2 * 73728 + 2 * 3456)
                      * BATCH * TH * TW, PEAK["bf16"])
    log(f"time conv1 backward {tuple(xb.shape)}: autograd function {k2b_ms:.4f} ms "
        f"(the plain ops, recomputing the block), plain graph's backward "
        f"{k2b_plain_ms:.4f} ms, bound {k2b_bound[0]:.4f} ms ({k2b_bound[1]}); forward "
        f"+ backward: K2 + backward {k2_fb_ms:.4f} ms, plain {plain_fb_ms:.4f} ms")
    del k2b, ins, y, y_plain, g, xb
    torch.cuda.empty_cache()

    # -- 11. the tiny float32 training step, card against CPU ----------------
    tiny_t = dataclasses.replace(zoo.tiny_test_config(), fc_dim=256)
    tts = TT.TrainSpec(stage=2, roi_batch=64)
    tss = TS.SolverSpec(type="sgd", base_lr=1e-3, lr_policy="fixed", momentum=0.9,
                        weight_decay=5e-4)
    tpc = M.init_params(torch.Generator().manual_seed(SEED), tiny_t, device="cpu")
    tlm, tdm = M.param_lr_multipliers(tpc, tiny_t), M.param_decay_multipliers(tpc, tiny_t)
    tbc = TSY.make_batch(tiny_t, batch=2, seed=SEED, with_labels=False, device="cpu")
    tdraws = TT.sample_draws(torch.Generator().manual_seed(SEED), tiny_t, tts, 2,
                             n_gt=tbc["gt_boxes"].shape[1])
    on_dev = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    results = {}
    for where, p_, b_, d_ in (("cpu", tpc, tbc, tdraws),
                              ("card", {k: on_dev(v) for k, v in tpc.items()},
                               on_dev(tbc), on_dev(tdraws))):
        rec = {}
        st = TT.make_train_step(tiny_t, tts, tss, tlm, tdm,
                                loss_function=functools.partial(TT.loss_fn, record=rec))
        new, m = st({"params": p_, "solver": TS.init_state(p_, tss)}, b_, draws=d_)
        results[where] = (new, m, rec["sample"])
    (nc_, mc, sc), (nd, md, sd) = results["cpu"], results["card"]
    if int(sc["n_fg"]) != int(sd["n_fg"]) or \
            not torch.equal(sc["labels"], sd["labels"].cpu()):
        fail(f"tiny step: the card sampled another roi set than the CPU (n_fg "
             f"{int(sd['n_fg'])} vs {int(sc['n_fg'])})")
    lrel = abs(float(md["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    if lrel > 1e-5:
        fail(f"tiny step: loss {float(md['loss'])} on the card, {float(mc['loss'])} on "
             f"the CPU (rel {lrel})")
    worst_max, worst_l2 = 0.0, 0.0
    for name, p in tpc.items():
        for k, w0 in p.items():
            dc = nc_["params"][name][k].double() - w0.double()
            dd = nd["params"][name][k].cpu().double() - w0.double()
            if not dc.abs().max() > 0:
                if not torch.equal(nd["params"][name][k].cpu(), nc_["params"][name][k]):
                    fail(f"tiny step: {name}.{k} moved on the card only")
                continue
            e = (dd - dc).abs().max().item() / dc.abs().max().item()
            l2 = ((dd - dc).norm() / dc.norm()).item()
            worst_max, worst_l2 = max(worst_max, e), max(worst_l2, l2)
            # a ReLU decision within f32 rounding of zero may go the other way
            # (tests/test_torch_train_step.py): max 1e-2, rel L2 2e-3 of the step
            if e > 1e-2 or l2 > 2e-3:
                fail(f"tiny step: {name}.{k}'s update differs between card and CPU "
                     f"(max {e:.3g}, rel L2 {l2:.3g} of the step)")
    log(f"tiny train step f32, card vs CPU, same draws: n_fg {int(sd['n_fg'])} and "
        f"labels equal, loss {float(md['loss']):.6f} (rel {lrel:.2g}), updates within "
        f"max {worst_max:.3g} / rel L2 {worst_l2:.3g} of the step")

    # the same step with the fused conv1 block and conv1 trainable: K2 forward
    # and its backward inside a step, then K2 on the updated weights
    tiny_k = dataclasses.replace(tiny_t, pallas_conv1=True)
    pk = {k: on_dev(v) for k, v in tpc.items()}
    zero_counts()
    st = TT.make_train_step(tiny_k, tts, tss)
    newk, mk = st({"params": pk, "solver": TS.init_state(pk, tss)}, on_dev(tbc),
                  draws=on_dev(tdraws))
    torch.cuda.synchronize()
    k2_train_launches = CK.launches
    if k2_train_launches < 1 or not math.isfinite(float(mk["loss"])):
        fail(f"the pallas_conv1 step launched K2 {k2_train_launches} times, loss "
             f"{float(mk['loss'])}")
    nw = newk["params"]
    ws = (nw["conv1_1"]["w"], nw["conv1_1"]["b"], nw["conv1_2"]["w"], nw["conv1_2"]["b"])
    if any(torch.equal(a, pk[n][k]) for a, (n, k) in zip(ws, (
            ("conv1_1", "w"), ("conv1_1", "b"), ("conv1_2", "w"), ("conv1_2", "b")))):
        fail("the pallas_conv1 step left a conv1 leaf unchanged")
    xk = (on_dev(tbc)["image"]).bfloat16()
    err, tol, eq, ulps, ok = conv1_compare(CK.conv1_pool_fused(xk, *ws).float(),
                                           CK.conv1_pool_plain(xk, *ws).float())
    if not ok:
        fail(f"K2 on the updated conv1 weights != plain (a stale weight packing?): "
             f"max_abs_err {err}, bit-equal share {eq}")
    log(f"tiny train step, pallas_conv1 and conv1 trainable: {k2_train_launches} K2 "
        f"launch(es), loss {float(mk['loss']):.6f}; K2 on the updated weights vs plain: "
        f"max_abs_err {err:.4g}, bit-equal share {eq:.6f}")
    del results, nc_, nd, newk, pk, tpc

    # -- 12. the flagship's stage-2 training step at full width ---------------
    fcfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=False),
                               compute_dtype="bfloat16", pallas_conv1=False)
    t0 = time.perf_counter()
    fp = M.init_params(torch.Generator().manual_seed(SEED), fcfg, device=dev)
    fp0 = {k: {n: t.clone() for n, t in p.items()} for k, p in fp.items()}
    flm, fdm = M.param_lr_multipliers(fp, fcfg), M.param_decay_multipliers(fp, fcfg)
    ftt = TT.TrainSpec(stage=2, with_metrics=False)
    fss = TS.SolverSpec(type="sgd", base_lr=5e-5, lr_policy="step", gamma=0.1,
                        stepsize=10000, momentum=0.9, weight_decay=5e-4)   # bench.py:96-99
    fstep = TT.make_train_step(fcfg, ftt, fss, lr_mults=flm, decay_mults=fdm)
    fb = TSY.make_batch(fcfg, batch=BATCH, seed=SEED, with_labels=False, device=dev)
    fb["image"] = torch.randint(0, 256, (BATCH, TH, TW, 3), generator=gen,
                                dtype=torch.uint8).to(dev)
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    state = {"params": fp, "solver": TS.init_state(fp, fss)}
    log(f"train: {fcfg.name} stage 2, batch {BATCH} at {TH}x{TW}, bf16 (f32 master "
        f"weights), plain conv1, roi batch {ftt.roi_batch}, max_nms_num "
        f"{fcfg.proposal.max_nms_num}, max_out {fcfg.proposal.max_out}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    # the training path's own run (its first step), launches read from it alone
    sink = calls_t = {"nms": [], "conv1": [], "int8": []}
    recording(True)
    zero_counts()
    t0 = time.perf_counter()
    state, fm = fstep(state, fb, generator=tgen)
    torch.cuda.synchronize()
    launches_t = counts()
    recording(False)
    log(f"train: first step {time.perf_counter() - t0:.2f} s, loss {float(fm['loss']):.5f}")
    if launches_t["nms"] != 1 or launches_t["conv1_pool"] != 0 or \
            launches_t["int8_gemm"] != 0:
        fail(f"a stage-2 training step launched {launches_t}, expected 1 nms")
    (na, nkw, nout), = calls_t["nms"]
    if tuple(na[0].shape) != (BATCH, fcfg.proposal.max_nms_num, 4) or \
            nkw["max_out"] != fcfg.proposal.max_out:
        fail(f"the training step's NMS ran at {tuple(na[0].shape)}, max_out "
             f"{nkw['max_out']}")
    if not nms_equal(nout, nms_ops.nms_xywh_plain(*na, **nkw)):
        fail("nms kernel != plain on the training step's propose")
    log(f"train: launches {launches_t}; K1 at P={BATCH} N={na[0].shape[1]} "
        f"max_out={nkw['max_out']} equal to plain: {int(na[2].sum())} valid "
        f"candidates, {int(nout[2].sum())} kept")
    t0 = time.perf_counter()
    for _ in range(2):
        state, fm = fstep(state, fb, generator=tgen)
    torch.cuda.synchronize()
    log(f"train: 2 warm-up steps {time.perf_counter() - t0:.2f} s, loss "
        f"{float(fm['loss']):.5f}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, fm = fstep(state, fb, generator=tgen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    train_step_s = statistics.median(times)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_loss = float(fm["loss"])
    if not math.isfinite(train_loss):
        fail(f"the training loss is {train_loss}")
    log(f"train: median {train_step_s * 1e3:.2f} ms/step over 5 synchronised steps "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}), {BATCH / train_step_s:.3f} "
        f"img/s, peak {train_peak:.2f} GiB, loss {train_loss:.5f}")
    # a CUDA-event split of a step (median of 3)
    parts = {}
    for _ in range(3):
        evs = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append((name, ev))

        mark("start")
        state, fm = fstep(state, fb, generator=tgen, mark=mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(evs, evs[1:]):
            parts.setdefault(name, []).append(a.elapsed_time(b))
    train_split = {k: statistics.median(v) for k, v in parts.items()}
    log("train_split_ms " + json.dumps(train_split))
    # K1 at the training shape, a call and on the device: on the first step's
    # candidates, and on random candidates of that shape (80% valid, the
    # path's random weights leave few or none above fg_thr)
    k1t = {}
    rb, rs, rv = random_candidates(gen, BATCH, na[0].shape[1], img=float(TW))
    rargs = (rb.to(dev), rs.to(dev), rv.to(dev))
    for tag, a in (("path", na), ("random", rargs)):
        o = nms_cuda(*a, **nkw)
        if not nms_equal(o, nms_ops.nms_xywh_plain(*a, **nkw)):
            fail(f"nms kernel != plain at the training shape ({tag} candidates)")
        kb = bound(sum(t.numel() * t.element_size() for t in (*a, *o)),
                   16 * int(o[2].sum()) * a[0].shape[1], PEAK["f32"])
        k1t[tag] = (cuda_ms(lambda: nms_cuda(*a, **nkw), iters=20),
                    cuda_ms(lambda: nms_ops.nms_xywh_plain(*a, **nkw), iters=3, warmup=1),
                    graph_ms(lambda: nms_cuda(*a, **nkw)), kb, int(o[2].sum()))
        log(f"time nms train P={BATCH} N={a[0].shape[1]} max_out={nkw['max_out']} "
            f"({tag} candidates, {int(a[2].sum())} valid, {k1t[tag][4]} kept): kernel "
            f"{k1t[tag][0]:.4f} ms a call, {k1t[tag][2]:.4f} ms on the device (CUDA "
            f"graph replay), plain {k1t[tag][1]:.4f} ms, bound {kb[0]:.5f} ms ({kb[1]})")
    del calls_t, sink
    # no host sync in a step (JAX's step is one program)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, fm = fstep(state, fb, generator=tgen)
    except RuntimeError as e:
        fail(f"the training step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("train: one step under sync debug mode 'error': no host sync")
    train_busy = trace_window(PROF, lambda: fstep(state, fb, generator=tgen),
                              "train_step", "two stage-2 training steps",
                              "the training step time above is a host-clock time")
    # the steps left the frozen layers as they were and moved every other leaf
    # (the profiled steps' states are dropped; `state` is the sync-checked step's)
    frozen = [n for n in fp0 if all(v == 0.0 for v in flm[n].values())]
    if sorted(frozen) != ["conv1_1", "conv1_2", "conv2_1", "conv2_2"]:
        fail(f"frozen layers {frozen}")   # the flagship has no 2x upsampler
    stuck = []
    for n, p in fp0.items():
        for k, w0 in p.items():
            same = torch.equal(state["params"][n][k], w0)
            if (n in frozen) != same:
                stuck.append(f"{n}.{k}")
    if stuck:
        fail(f"after the training steps, frozen leaves moved or trainable ones did "
             f"not: {stuck}")
    log(f"train: after {int(state['solver']['it'])} steps {', '.join(frozen)} are "
        f"bit-unchanged and all {sum(len(p) for n, p in fp0.items() if n not in frozen)} "
        f"trainable leaves moved")
    del state, fp, fp0, fb, fm
    torch.cuda.empty_cache()
    if jax_loaded():
        fail("the training phases imported jax or the JAX package")

    # -- 13. the training entry point: prototxts, window file, train2 ----------
    tr = training_entry_point(dev, counts, zero_counts, PROF)

    # -- 14. the cascade deploy paths ------------------------------------------
    def rec_into(on, target):
        nonlocal sink
        sink = target
        recording(on)

    cd = cascade_deploy(dev, counts, zero_counts, PROF, rec_into)
    nms_max_err = max(nms_max_err, cd["nms_err"])
    conv1_max_err = max(conv1_max_err, cd["conv1_err"])
    conv1_min_share = min(conv1_min_share, cd["conv1_share"])
    int8_max_err = max(int8_max_err, cd["int8_err"])

    # -- 15. cascade training through cli train2 --------------------------------
    ct = cascade_training(dev, counts, zero_counts, PROF)
    conv1_max_err = max(conv1_max_err, ct["k2_err"])
    conv1_min_share = min(conv1_min_share, ct["k2_share"])

    # -- 16. the deploy entry points: detect, compile, the artifact, serve ------
    ep = deploy_entry_points(dev, counts, zero_counts, PROF, rec_into)
    nms_max_err = max(nms_max_err, ep["nms_err"])
    conv1_max_err = max(conv1_max_err, ep["conv1_err"])
    conv1_min_share = min(conv1_min_share, ep["conv1_share"])
    int8_max_err = max(int8_max_err, ep["int8_err"])

    # -- 17. JPEG without cv2; train2 from a JPEG shard through the worker loader
    try:
        jp = jpeg_input_path(dev, counts, zero_counts, PROF, rec_into, ep, tr)
    finally:
        shutil.rmtree(ep["root"], ignore_errors=True)
    nms_max_err = max(nms_max_err, jp["nms_err"])
    conv1_max_err = max(conv1_max_err, jp["conv1_err"])
    conv1_min_share = min(conv1_min_share, jp["conv1_share"])
    int8_max_err = max(int8_max_err, jp["int8_err"])

    # -- 18. the generic prototxt nets: LeNet, VGG16's Classifier, time --layers
    gn = generic_nets(dev, counts, zero_counts)

    # -- 19. Caffe databases: convert_imageset, Data layers, compute_mean, HDF5
    cdb = caffe_databases(dev, counts, zero_counts, gn)

    # -- 20. the tools: the JPEG encoder, resize_images, extract_features, ...
    tl = tools(dev, counts, zero_counts, jp["decode_ms"])

    # -- 21. data parallelism: the mesh step, two ranks, the deploy mesh ---------
    dpr = data_parallel(dev, counts, zero_counts, rec_into)
    nms_max_err = max(nms_max_err, dpr["nms_err"])
    conv1_max_err = max(conv1_max_err, dpr["conv1_err"])
    conv1_min_share = min(conv1_min_share, dpr["conv1_share"])
    int8_max_err = max(int8_max_err, dpr["int8_err"])

    # -- 22. the data x space step: (1, 1) bit-equal, two ranks' bands, s2d ----
    spr = spmd_phase(dev, counts, zero_counts, rec_into)
    nms_max_err = max(nms_max_err, spr["nms_err"])
    conv1_max_err = max(conv1_max_err, spr["conv1_err"])
    conv1_min_share = min(conv1_min_share, spr["conv1_share"])

    # -- 23. the example drivers and train_mscnn.sh ------------------------------
    exr = examples_phase(dev, counts, zero_counts)
    nms_max_err = max(nms_max_err, exr["nms_err"])
    conv1_max_err = max(conv1_max_err, exr["conv1_err"])
    conv1_min_share = min(conv1_min_share, exr["conv1_share"])
    int8_max_err = max(int8_max_err, exr["int8_err"])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"train entry on {card}: iteration {tr['iter_ms']:.2f} ms (median), input "
        f"wait {tr['wait_ms']:.2f} ms a step = {tr['wait_share']:.4f} of the "
        f"iteration, snapshot {tr['snapshot_torch_ms']:.1f} ms (port directory) / "
        f"{tr['snapshot_caffemodel_ms']:.1f} ms (.caffemodel + .solverstate), peak "
        f"{tr['peak_gib']:.2f} GiB, host resize {tr['resize_ms']:.2f} ms an image and "
        f"{tr['batch_ms']:.2f} ms a batch, device busy share "
        + (f"{tr['busy']:.4f}" if tr["busy"] is not None else "not measured")
        + f" (two loop iterations); resume {tr['resume']}")
    for tag in ("kitti", "int8", "widerface"):
        f = cd[tag]
        log(f"cascade {tag} on {card}: step {f['step_ms']:.2f} ms = {f['img_s']:.2f} "
            f"img/s, stage heads {sum(f['split'][k] for k in ('stage_1', 'stage_2', 'stage_3')):.3f}"
            f" ms of the split's {sum(f['split'].values()):.3f}, peak {f['peak_gib']:.2f} "
            f"GiB, busy share " + (f"{f['busy']:.4f}" if f["busy"] is not None
                                   else "not measured"))
    for tag, f in ep["artifact"].items():
        log(f"entry artifact {tag} on {card}: step {f['ms']:.3f} ms (eager "
            f"{f['eager_ms']:.3f} ms) = {f['img_s']:.2f} img/s (eager "
            f"{f['eager_img_s']:.2f}), host enqueue {f['host_ms']:.2f} ms (eager "
            f"{f['eager_host_ms']:.2f}), busy share "
            + (f"{f['busy']:.4f}" if f["busy"] is not None else "not measured"))
    sv = ep["serve"]
    log(f"entry serve on {card}: {sv['img_s']:.2f} img/s, p50 {sv['p50_ms']:.1f} ms, "
        f"p99 {sv['p99_ms']:.1f} ms, {sv['dispatches']} device calls for 16 requests; "
        f"detect split {ep['detect_split_ms']}; time {ep['time']}; eval {ep['eval']}")
    log(f"cascade train on {card}: iteration {ct['iter_ms']:.2f} ms (median), input "
        f"wait {ct['wait_ms']:.2f} ms a step = {ct['wait_share']:.4f} of the "
        f"iteration, peak {ct['peak_gib']:.2f} GiB, busy share "
        + (f"{ct['busy']:.4f}" if ct["busy"] is not None else "not measured"))

    log(f"jpeg on {card}: decode {jp['decode_ms']:.1f} ms a 375x1242 JPEG; detect "
        f"split {jp['split_ms']}; steady {jp['detect_s_img']} s/img; input wait a "
        f"train2 step and its share: " + "; ".join(
            f"{k} {v['wait_ms']:.2f} ms, {v['wait_share']:.4f} ({v['iter_ms']:.2f} ms an "
            f"iteration)" for k, v in jp["train"].items()))

    ln, vg = gn["lenet"], gn["vgg16"]
    log(f"generic on {card}: LeNet step {ln['iter_ms']:.3f} ms, host batch "
        f"{ln['host_batch_ms']:.2f} ms, cli {ln['cli_iter_ms']:.2f} ms an iteration; "
        f"VGG16 10-crop forward {vg['forward_ms']:.3f} ms "
        f"({vg['flops'] / vg['forward_ms'] / 1e9:.1f} TFLOP/s), predict "
        f"{vg['predict_ms']:.1f} ms; time --layers top five (fwd, fwd+bwd ms): "
        + "; ".join(f"{n} {f:.3f} / {b:.3f}" for n, f, b in gn["layers_top5"]))

    dl = cdb["lenet"]
    log(f"databases on {card}: " + "; ".join(
        f"{k} written {v['write_rec_s']:.0f} records/s, {v['bytes']} bytes, read "
        f"{v['read_rec_s']:.0f} records/s" for k, v in cdb["db"].items())
        + f"; LeNet on Data layers: step {dl['iter_ms']:.3f} ms, host batch "
        f"{dl['host_batch_ms']:.2f} ms, cli {dl['cli_iter_ms']:.2f} ms an iteration "
        f"(ImageData: {ln['iter_ms']:.3f} / {ln['host_batch_ms']:.2f} / "
        f"{ln['cli_iter_ms']:.2f}), loss {dl['loss'][0]:.4f} -> {dl['loss'][1]:.4f}, "
        f"test {dl['test']}; crc32c {cdb['crc32c_mb_s']['lanes']:.1f} MB/s (the byte "
        f"loop {cdb['crc32c_mb_s']['byte_loop']:.2f}); phase 19 {cdb['seconds']:.1f} s")

    ex = tl["extract_ms"]
    log(f"tools on {card}: JPEG encode {tl['encode_ms']:.1f} ms a 375x1242 scene "
        f"({tl['encode_mb_s']:.1f} MB/s), decode {tl['decode_ms']:.1f} ms; "
        f"extract_features on the flagship: decode {ex['decode']:.1f}, resize "
        f"{ex['resize']:.1f}, forward {ex['forward']:.1f} ms an image, peak "
        f"{tl['peak_gib']:.2f} GiB; the commands {tl['cases_s']:.1f} s; phase 20 "
        f"{tl['seconds']:.1f} s")

    da, db = dpr["a"], dpr["b"]
    log(f"data parallel on {card}: flagship step (batch {DP_BATCH}, bf16, K2 + K1) "
        f"{da['mesh_ms']:.2f} ms through the mesh at world size 1 (NCCL), "
        f"{da['plain_ms']:.2f} ms without; all-reduce {da['all_reduce_mb']:.1f} MB in "
        f"{da['all_reduce_ms']:.3f} ms (NCCL alone {da['nccl_ms']:.3f}); two gloo ranks "
        f"on one card: step ms {db['ms']}, rank 0's split {db['split']}; against one "
        "process: " + ("bit-equal" if db["bit_equal"] else f"worst {db['worst']:.3g}")
        + f"; phase 21 {dpr['seconds']:.1f} s")

    sa, sb = spr["a"], spr["b"]
    log(f"spmd on {card}: one-process flagship step {sa['plain_ms']:.1f} ms, peak "
        f"{gib(sa['mem']['peak']):.3f} GiB; two gloo ranks of (1, 2): step ms "
        f"{[[round(t, 1) for t in m] for m in sb['ms']]}, peak GiB "
        f"{[round(gib(m['peak']), 3) for m in sb['mem']]}, halo "
        f"{sb['split'][0].get('halo', 0.0):.2f} ms, gather "
        f"{sb['split'][0].get('gather', 0.0):.2f} ms, all-reduce "
        f"{sb['split'][0].get('all_reduce', 0.0):.2f} ms; s2d deploy forward "
        f"{spr['s2d']['ms']['s2d']:.3f} ms against plain conv1 "
        f"{spr['s2d']['ms']['plain']:.3f}; phase 22 {spr['seconds']:.1f} s")

    ex = exr["results"]
    log(f"examples on {card}: stages 8s768 (b1, K2) trunk / heads / propose / full "
        + " / ".join(f"{ex['profile_stages_8s768'][f'{k}_ms']:.2f}" for k in
                     ("trunk", "heads", "propose", "full"))
        + " ms (full: plain conv1 " + " / s2d ".join(
            f"{ex[f'MSCNN_CONV1={r} profile_stages_8s768']['full_ms']:.2f}"
            for r in ("plain", "s2d"))
        + " ms); ROI stage deltas " + ", ".join(
            f"{k} {ex['profile_roi_stage'][f'{k}_delta_ms']:.3f}" for k in
            ("upsample", "table", "pools", "full_roi_head"))
        + f" ms; train step pruning saving {ex['profile_train_step']['pruning_saving_ms']:.1f}"
        f" ms; widerface propose delta {ex['profile_widerface_stages']['propose_delta']:.3f} "
        f"ms; synthetic_e2e AP {ex['synthetic_e2e']['ap']} int8 "
        f"{ex['synthetic_e2e']['ap_int8']} (each launch held inline: the times include "
        f"the checks); phase 23 {exr['seconds']:.1f} s")

    def examples_launches(k):
        """The kernel's launches in each run of phase 23."""
        return {tag: v[k] for tag, v in exr["launches"].items()}

    def spmd_launches(k):
        """The kernel's launches in each run of phase 22."""
        return {tag: v[k] for tag, v in spr["launches"].items()}

    def dp_launches(k):
        """The kernel's launches in each run of phase 21."""
        return {tag: v[k] for tag, v in dpr["launches"].items()}

    def jpeg_launches(k):
        """The kernel's launches in each run of phase 17."""
        return {tag: v[k] for tag, v in jp["launches"].items()}

    def entry_launches(k):
        """The kernel's launches in each run of phase 16 (the CLI runs, the
        loaded artifacts' checked calls)."""
        return {**{tag: v[k] for tag, v in ep["launches"].items()},
                **{f"artifact {tag}": v["launches"][k]
                   for tag, v in ep["artifact"].items()}}

    kernels = [
        {"name": "nms_xywh", "route": "cuda",
         "source": "mscnn_torch/csrc/nms.cu",
         "replaces": "mscnn_tpu/ops/pallas/nms_kernel.py:98",
         "launches": launches["nms"], "launches_int8_path": launches8["nms"],
         "max_abs_err": nms_max_err,
         "ms": kernels_ms["nms_propose"][0], "plain_ms": kernels_ms["nms_propose"][1],
         "bound_ms": nms_bound[0], "bound_by": nms_bound[1], "library_ms": None,
         "postprocess_ms": kernels_ms["nms_postprocess"][0],
         "postprocess_plain_ms": kernels_ms["nms_postprocess"][1],
         "device_ms": {"propose": kernels_ms["nms_propose"][2],
                       "postprocess": kernels_ms["nms_postprocess"][2]},
         "design": "sorted-order scan",
         "launches_train_step": launches_t["nms"],
         "launches_train_entry": tr["launches"]["nms"],
         "launches_cascade": {"kitti": cd["launches"]["nms"],
                              "int8": cd["launches8"]["nms"],
                              "widerface_align": cd["launches_wf"]["nms"],
                              "train2": ct["launches"]["nms"]},
         "launches_entry_points": entry_launches("nms"),
         "launches_jpeg_input": jpeg_launches("nms"),
         "launches_generic_nets": gn["launches"]["nms"],
         "launches_caffe_databases": cdb["launches"]["nms"],
         "launches_tools": tl["launches"]["nms"],
         "launches_data_parallel": dp_launches("nms"),
         "launches_spmd": spmd_launches("nms"),
         "launches_examples": examples_launches("nms"),
         "op": "mscnn::nms_xywh", "op_overhead_us": ep["op_overhead_us"]["nms_xywh"],
         "train": {tag: {"shape": [BATCH, fcfg.proposal.max_nms_num,
                                   fcfg.proposal.max_out], "kept": v[4],
                         "ms": v[0], "plain_ms": v[1], "device_ms": v[2],
                         "bound_ms": v[3][0], "bound_by": v[3][1]}
                   for tag, v in k1t.items()}},
        {"name": "conv1_pool_fused", "route": "cuda",
         "source": "mscnn_torch/csrc/conv1_pool.cu",
         "replaces": "mscnn_tpu/ops/pallas/conv1_kernel.py:280",
         "launches": launches["conv1_pool"], "max_abs_err": conv1_max_err,
         "ms": kernels_ms["conv1"][0], "plain_ms": kernels_ms["conv1"][1],
         "bound_ms": conv1_bound[0], "bound_by": conv1_bound[1], "library_ms": None,
         "design": "persistent, both convs on wgmma", "min_bit_equal_share": conv1_min_share,
         "cudnn_unfused_ms": sum(k3["4x768x2560"]["cudnn"].values()),
         "k3_best_ms": k3["4x768x2560"]["k3_best"][1],
         "launches_train_step": launches_t["conv1_pool"],
         "launches_train_entry": tr["launches"]["conv1_pool"],
         "launches_cascade": {"kitti": cd["launches"]["conv1_pool"],
                              "int8": cd["launches8"]["conv1_pool"],
                              "widerface_align": cd["launches_wf"]["conv1_pool"],
                              "train2": ct["launches"]["conv1_pool"]},
         "launches_entry_points": entry_launches("conv1_pool"),
         "launches_jpeg_input": jpeg_launches("conv1_pool"),
         "launches_generic_nets": gn["launches"]["conv1_pool"],
         "launches_caffe_databases": cdb["launches"]["conv1_pool"],
         "launches_tools": tl["launches"]["conv1_pool"],
         "launches_data_parallel": dp_launches("conv1_pool"),
         "launches_spmd": spmd_launches("conv1_pool"),
         "launches_examples": examples_launches("conv1_pool"),
         "op": "mscnn::conv1_pool", "op_overhead_us": ep["op_overhead_us"]["conv1_pool"],
         "train_entry_min_bit_equal_share": tr["k2_share"],
         "launches_train_pallas_tiny": k2_train_launches,
         "backward": "autograd, plain ops",
         "backward_shape": [BATCH, TH, TW, 3], "backward_ms": k2b_ms,
         "backward_plain_ms": k2b_plain_ms, "backward_bound_ms": k2b_bound[0],
         "backward_bound_by": k2b_bound[1], "backward_library_ms": None,
         "fwd_bwd_ms": k2_fb_ms, "fwd_bwd_plain_ms": plain_fb_ms},
        {"name": "int8_gemm", "route": "cuda",
         "source": "mscnn_torch/csrc/int8_gemm.cu",
         "replaces": "examples/profile_int8_mxu.py:84",
         "launches": launches8["int8_gemm"], "max_abs_err": int8_max_err,
         "ms": int8_ms, "plain_ms": int8_plain_ms,
         "bound_ms": sum(k4_bound.values()), "bound_by": max(k4_bound, key=k4_bound.get),
         "library_ms": None,
         "bf16_cudnn_ms": sum(v["bf16_cudnn"] for v in layer_ms.values()),
         "int_mm": int_mm, "probe_launches": probe8_launches["int8_gemm"],
         "launches_cascade": {"kitti": cd["launches"]["int8_gemm"],
                              "int8": cd["launches8"]["int8_gemm"],
                              "widerface_align": cd["launches_wf"]["int8_gemm"],
                              "train2": ct["launches"]["int8_gemm"]},
         "launches_entry_points": entry_launches("int8_gemm"),
         "launches_jpeg_input": jpeg_launches("int8_gemm"),
         "launches_generic_nets": gn["launches"]["int8_gemm"],
         "launches_caffe_databases": cdb["launches"]["int8_gemm"],
         "launches_tools": tl["launches"]["int8_gemm"],
         "launches_data_parallel": dp_launches("int8_gemm"),
         "launches_spmd": spmd_launches("int8_gemm"),
         "launches_examples": examples_launches("int8_gemm"),
         "op": "mscnn::int8_conv", "op_overhead_us": ep["op_overhead_us"]["int8_conv"],
         "per_step": "sum of the 17 launches of one int8 deploy step; no one "
                     "PyTorch call computes an int8 conv with its epilogue, "
                     "torch._int_mm computes the raw int32 product at the "
                     "probe shapes and fc6 (int_mm)"},
        {"name": "conv1_v5", "route": "cuda",
         "source": "mscnn_torch/csrc/conv1_v5.cu",
         "replaces": "examples/profile_conv1_v5.py:160",
         "launches": probe_launches["conv1_v5"], "max_abs_err": k3_max_err,
         "launches_generic_nets": gn["launches"]["conv1_v5"],
         "launches_caffe_databases": cdb["launches"]["conv1_v5"],
         "launches_tools": tl["launches"]["conv1_v5"],
         "launches_data_parallel": dp_launches("conv1_v5"),
         "launches_spmd": spmd_launches("conv1_v5"),
         "launches_examples": examples_launches("conv1_v5"),
         "min_bit_equal_share": k3_min_share,
         "ms": k3["1x768x2560"]["kernel"][f"{default_mode}_{th0}x{tq0}"],
         "plain_ms": k3["1x768x2560"]["plain"][default_mode],
         "bound_ms": k3["1x768x2560"]["bound"][0],
         "bound_by": k3["1x768x2560"]["bound"][1],
         "library_ms": sum(k3["1x768x2560"]["cudnn"].values()),
         "library_call": "cuDNN unfused conv1_1 + conv1_2 + pool1 (three calls; no one "
                         "PyTorch call fuses the block)",
         "design": "K2's persistent wgmma schedule (conv1_block.cuh)",
         "shape": "[1, 768, 2560, 3], mode mc, tile 16x16 (the probe's path)",
         "ms_by_mode": {m: k3["1x768x2560"]["kernel"][f"{m}_{th0}x{tq0}"]
                        for m in P5.MODES},
         "plain_ms_by_mode": k3["1x768x2560"]["plain"],
         "ms_by_tile": {t: {k: v for k, v in k3[t]["kernel"].items()} for t in k3},
         "k2_ms": {t: k3[t]["k2"] for t in k3},
         "plain_block_ms": {t: k3[t]["plain_block"] for t in k3},
         "cudnn_unfused_ms": {t: k3[t]["cudnn"] for t in k3},
         "bound_ms_batch4": k3["4x768x2560"]["bound"][0]},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[1:])
    elif sys.argv[1:2] == ["--spmd-rank"]:
        spmd_rank_main(sys.argv[1:])
    elif sys.argv[1:2] == ["--cli-child"]:
        cli_child_main(sys.argv[1:])
    else:
        main()
