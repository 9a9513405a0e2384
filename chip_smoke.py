#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`mscnn_torch`) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the root of the repository

Phases (any failure exits non-zero, before the result line):
  1. build   -- compile every CUDA kernel of the deploy paths from
                mscnn_torch/csrc/ (one nvcc per source, in parallel);
  2. nms     -- the NMS kernel against its plain version at the deploy
                path's two shapes and in each IoU mode: exactly equal;
  3. conv1   -- the fused conv1 kernel against its plain version at
                [4, 768, 2560, 3] and at an odd size: atol 0.02 * max|ref|;
  3b. conv1_v5 -- K3, the conv1 kernel with a selectable MMA schedule, in
                each mode (serial, mc, flat, bf16) against its plain version
                at the probe's [1, 768, 2560, 3] and at [1, 19, 37, 3], and
                in the default mode at [4, 768, 2560, 3]: atol 0.02 *
                max|ref| (and the share of bit-equal outputs in mode bf16);
                serial / mc / flat within the same bound of K2's kernel on
                the same input; bf16 measurably different from serial;
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
  8. conv1 probes -- K3 in each mode and tile beside K2, the plain block
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
                device time.

The lines before the last give the card's name and power limit
(nvidia-smi) and one JSON object listing every kernel, each with its
launches on its path, time, plain time, bound (the larger of the bytes
it must move over 3.35 TB/s and its operations over the peak of their
type) and library-call time (null where no one PyTorch call computes the
same function); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, the script exits non-zero and prints no result.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 4
SEED = 0
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


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def check_kitti(I, out, batch):
    """Write the batch's detections as KITTI label files; fail on a malformed
    line. Returns (line count, first line)."""
    with tempfile.TemporaryDirectory() as tmp:
        names = I.KITTI_CLASS_NAMES["kitti_car"]
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
    except ImportError as e:
        fail(f"mscnn_torch not importable ({e}); run from the repository root")
    if "jax" in sys.modules:
        fail("the port imported jax")

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
    nms_cases = [(4, 2000, 256, 0.65, "iou"), (16, 256, 100, 0.5, "iou")] + [
        (3, 300, 64, 0.5, m) for m in ("iou", "iomu", "iofu")]
    nms_max_err = 0.0
    for p, n, max_out, thr, mode in nms_cases:
        b, s, v = (t.to(dev) for t in random_candidates(gen, p, n))
        kw = dict(iou_thr=thr, mode=mode, max_out=max_out)
        got = nms_ops.nms_xywh(b, s, v, **kw)
        want = nms_ops.nms_xywh_plain(b, s, v, **kw)
        torch.cuda.synchronize()
        if not nms_equal(got, want):
            fail(f"nms kernel != plain at P={p} N={n} max_out={max_out} {mode}")
        nms_max_err = max(nms_max_err, nms_err(got, want))
        log(f"nms: P={p} N={n} max_out={max_out} thr={thr} {mode}: equal "
            f"({int(got[2].sum())} kept)")

    # -- 3. conv1 kernel vs plain --------------------------------------------
    cfg = dataclasses.replace(zoo.kitti_car_8s_768(deploy=True, max_out=256),
                              compute_dtype="bfloat16", pallas_conv1=True)
    t0 = time.perf_counter()
    params = M.cast_params(M.init_params(gen, cfg, device=dev), torch.bfloat16)
    log(f"params: {sum(t.numel() for p in params.values() for t in p.values())} "
        f"(seeded random, bf16) in {time.perf_counter() - t0:.1f} s")
    w1, b1 = params["conv1_1"]["w"], params["conv1_1"]["b"]
    w2, b2 = params["conv1_2"]["w"], params["conv1_2"]["b"]
    conv1_max_err = 0.0

    def conv1_check(x, tag):
        nonlocal conv1_max_err
        got = CK.conv1_pool_fused(x, w1, b1, w2, b2).float()
        want = CK.conv1_pool_plain(x, w1, b1, w2, b2).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 0.02 * want.abs().max().item()
        log(f"conv1 {tag}: {tuple(x.shape)} max_abs_err {err:.4g} "
            f"(atol {tol:.4g}, max|ref| {want.abs().max().item():.4g})")
        if not (got.shape == want.shape and err <= tol):
            fail(f"conv1 kernel != plain at {tag} {tuple(x.shape)}: {err} > {tol}")
        conv1_max_err = max(conv1_max_err, err)

    H, W = cfg.input_hw
    mean = torch.tensor(MEAN, device=dev)
    imgs = torch.randint(0, 256, (BATCH, H, W, 3), generator=gen,
                         dtype=torch.uint8).to(dev)
    conv1_check((imgs.float() - mean).bfloat16(), "path shape")
    odd_x = (torch.randn((1, 19, 37, 3), generator=gen) * 50).to(dev).bfloat16()
    conv1_check(odd_x, "odd size")

    # -- 3b. K3 (conv1_v5) vs plain, every mode ---------------------------------
    k3_max_err = 0.0

    def k3_check(x, ws, mode, tag):
        nonlocal k3_max_err
        got = K3.conv1_v5(x, *ws, mode=mode).float()
        want = K3.conv1_v5_plain(x, *ws, mode=mode).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 0.02 * want.abs().max().item()
        eq = (got == want).float().mean().item()
        log(f"conv1_v5 {mode} {tag}: {tuple(x.shape)} max_abs_err {err:.4g} "
            f"(atol {tol:.4g}), bit-equal share {eq:.6f}")
        if not (got.shape == want.shape and err <= tol):
            fail(f"conv1_v5 kernel != plain in mode {mode} at {tag} "
                 f"{tuple(x.shape)}: {err} > {tol}")
        k3_max_err = max(k3_max_err, err)
        return got, tol

    probe_in = P5.make_inputs(dev)   # the probe's x [1, 768, 2560, 3] and weights
    zero_counts()
    for tag, x, ws in (("probe shape", probe_in[0], probe_in[1:]),
                       ("odd size", odd_x, (w1, b1, w2, b2))):
        k2 = CK.conv1_pool_fused(x, *ws).float()
        outs = {}
        for mode in P5.MODES:
            outs[mode], tol = k3_check(x, ws, mode, tag)
            if mode != "bf16":   # K2's function
                e2 = (outs[mode] - k2).abs().max().item()
                log(f"conv1_v5 {mode} {tag}: vs K2's kernel max_abs_err {e2:.4g}")
                if e2 > tol:
                    fail(f"conv1_v5 {mode} != K2's kernel at {tag}: {e2} > {tol}")
        differ = (outs["bf16"] != outs["serial"]).float().mean().item()
        log(f"conv1_v5 bf16 vs serial {tag}: {differ:.4f} of the outputs differ")
        if differ == 0:
            fail(f"conv1_v5 mode bf16 gave mode serial's output at {tag}")
        del outs, k2
    k3_check((imgs.float() - mean).bfloat16(), (w1, b1, w2, b2), "mc", "deploy batch")
    k3_phase = K3.launches
    if k3_phase != 2 * len(P5.MODES) + 1:
        fail(f"the conv1_v5 phase launched K3 {k3_phase} times, expected "
             f"{2 * len(P5.MODES) + 1}")
    log(f"conv1_v5: {k3_phase} launches in the phase, all within atol")
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
        err = (got.float() - want).abs().max().item()
        tol = 0.02 * want.abs().max().item()
        log(f"conv1 on path: {tuple(a[0].shape)} max_abs_err {err:.4g} "
            f"(atol {tol:.4g})")
        if err > tol:
            fail(f"conv1 kernel != plain on the main path's batch: {err}")
        conv1_max_err = max(conv1_max_err, err)

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
        p_ms = cuda_ms(lambda: nms_ops.nms_xywh_plain(*a, **kw), iters=5)
        kernels_ms[f"nms_{tag}"] = (k_ms, p_ms)
        log(f"time nms {tag} P={a[0].shape[0]} N={a[0].shape[1]} "
            f"max_out={kw['max_out']}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    # K1's bound: the bytes of its inputs and outputs, against the steps this
    # run's data needs (one per kept box: an argmax and an IoU row over N
    # candidates, ~16 f32 operations a candidate, on the CUDA cores)
    pout = max(calls["nms"], key=lambda c: c[0][0].shape[1])[2]
    nms_bytes = sum(t.numel() * t.element_size() for t in (*pa, *pout))
    nms_ops = 16 * int(pout[2].sum()) * pa[0].shape[1]
    nms_bound = bound(nms_bytes, nms_ops, PEAK["f32"])
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
        log(f"time conv1 probes {tag}: K2 {k2_before:.4f} / {k2_after:.4f} ms "
            f"(before / after K3), plain block {r['plain_block']:.4f} ms, cuDNN "
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
    with tempfile.TemporaryDirectory() as tdir:
        with PROF.trace(tdir) as prof:
            for _ in range(2):
                with PROF.annotate("deploy_step"):
                    fwd(params, imgs, ratios, orig_wh)
            torch.cuda.synchronize()
        with open(os.path.join(tdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    dev_total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages())
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "deploy_step"]
    busy_share = None
    if busy and steps and dev_total > 0:
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
        log(f"trace: two bf16 deploy steps, window {(hi - lo) / 1e3:.3f} ms, device "
            f"busy {union / 1e3:.3f} ms = share {busy_share:.4f}, idle share "
            f"{1 - busy_share:.4f}; {len(busy)} device events")
        for n_, (cnt, t_) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
            log(f"trace kernel {t_ / 1e3:9.3f} ms {cnt:5d}x  {n_[:110]}")
    else:
        log("trace: device busy share not measured: the profiler window holds no "
            f"device time ({len(busy)} device events, key_averages device total "
            f"{dev_total}); the step times above are host-clock times")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]

    kernels = [
        {"name": "nms_xywh", "route": "cuda",
         "source": "mscnn_torch/csrc/nms.cu",
         "replaces": "mscnn_tpu/ops/pallas/nms_kernel.py:98",
         "launches": launches["nms"], "launches_int8_path": launches8["nms"],
         "max_abs_err": nms_max_err,
         "ms": kernels_ms["nms_propose"][0], "plain_ms": kernels_ms["nms_propose"][1],
         "bound_ms": nms_bound[0], "bound_by": nms_bound[1], "library_ms": None,
         "postprocess_ms": kernels_ms["nms_postprocess"][0],
         "postprocess_plain_ms": kernels_ms["nms_postprocess"][1]},
        {"name": "conv1_pool_fused", "route": "cuda",
         "source": "mscnn_torch/csrc/conv1_pool.cu",
         "replaces": "mscnn_tpu/ops/pallas/conv1_kernel.py:280",
         "launches": launches["conv1_pool"], "max_abs_err": conv1_max_err,
         "ms": kernels_ms["conv1"][0], "plain_ms": kernels_ms["conv1"][1],
         "bound_ms": conv1_bound[0], "bound_by": conv1_bound[1], "library_ms": None},
        {"name": "int8_gemm", "route": "cuda",
         "source": "mscnn_torch/csrc/int8_gemm.cu",
         "replaces": "examples/profile_int8_mxu.py:84",
         "launches": launches8["int8_gemm"], "max_abs_err": int8_max_err,
         "ms": int8_ms, "plain_ms": int8_plain_ms,
         "bound_ms": sum(k4_bound.values()), "bound_by": max(k4_bound, key=k4_bound.get),
         "library_ms": None,
         "bf16_cudnn_ms": sum(v["bf16_cudnn"] for v in layer_ms.values()),
         "int_mm": int_mm, "probe_launches": probe8_launches["int8_gemm"],
         "per_step": "sum of the 17 launches of one int8 deploy step; no one "
                     "PyTorch call computes an int8 conv with its epilogue, "
                     "torch._int_mm computes the raw int32 product at the "
                     "probe shapes and fc6 (int_mm)"},
        {"name": "conv1_v5", "route": "cuda",
         "source": "mscnn_torch/csrc/conv1_v5.cu",
         "replaces": "examples/profile_conv1_v5.py:160",
         "launches": probe_launches["conv1_v5"], "max_abs_err": k3_max_err,
         "ms": k3["1x768x2560"]["kernel"][f"{default_mode}_{th0}x{tq0}"],
         "plain_ms": k3["1x768x2560"]["plain"][default_mode],
         "bound_ms": k3["1x768x2560"]["bound"][0],
         "bound_by": k3["1x768x2560"]["bound"][1], "library_ms": None,
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
    main()
