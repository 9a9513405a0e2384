"""Stage breakdown of the 3-stage cascade deploy graph on the card.

Ports `examples/profile_cascade_stages.py`: kitti_car/cascade-mscnn-7s-
576-2x at 576x1920, batch 1, bf16 (seeded random weights and image), with
the cumulative figures trunk -> +heads -> +propose -> +stage 1 -> +stage 2
-> full (3 stages and the post-processing), for max_out 512 (the zoo
default) and 256. The JAX script compiles one graph per cut; here the
deploy runs eagerly, so one pass with a CUDA event at each of
`cascade.deploy_forward`'s marks gives every part (`stage_split`, which
chip_smoke.py's cascade phase uses too).

    python3 -m mscnn_torch.examples.profile_cascade_stages [--batch 4] [--iters 5]

The last line is one JSON object: per max_out, each part's median ms
(CUDA events), the cumulative ms and the host-clock step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from mscnn_torch import inference as I
from mscnn_torch.models import cascade as CC
from mscnn_torch.models import mscnn as M
from mscnn_torch.models import zoo

PARTS = ("trunk", "heads", "propose", "stage_1", "stage_2", "stage_3",
         "ensemble", "postprocess")
MEAN = (104.0, 117.0, 123.0)


def stage_split(params, img_u8, ccfg, ratios, orig_wh, spec=I.DetectSpec(),
                iters=3, mean_values=MEAN):
    """Median CUDA-event ms of each part of one cascade detect step (uint8
    images on the card -> KITTI-ready detections) over `iters` passes after
    a warm-up: the marks of `cascade.deploy_forward` ("ensemble" 0.0 where
    the ensemble does not run), then "postprocess" (bbox expansion,
    decode, per-class NMS)."""
    cfg = ccfg.base
    times = {k: [] for k in PARTS}
    mean = torch.tensor(mean_values, device=img_u8.device)
    with torch.inference_mode():
        for it in range(iters + 1):
            events = [("start", torch.cuda.Event(enable_timing=True))]
            events[0][1].record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            out = I.cascade_deploy_outputs(params, img_u8.float() - mean, ccfg,
                                           mark=mark)
            out = I.expand_cascade_bbox(out, cfg.num_classes)
            per = I._per_image(out, img_u8.shape[0], cfg.proposal.max_out)
            I.postprocess_batch(per, ratios, orig_wh, I.cascade_post_cfg(ccfg), spec)
            mark("postprocess")
            events[-1][1].synchronize()
            if it:   # the first pass is a warm-up
                got = {k: 0.0 for k in PARTS}
                for (_, a), (name, b) in zip(events, events[1:]):
                    got[name] = a.elapsed_time(b)
                for k in PARTS:
                    times[k].append(got[k])
    return {k: statistics.median(v) for k, v in times.items()}


def step_ms(params, img_u8, ccfg, ratios, orig_wh, iters=5):
    """Median host-clock ms of a synchronised detect step (forward +
    post-processing) after 2 warm-ups."""
    out = []
    for i in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        I._cascade_detect(params, img_u8, ratios, orig_wh, ccfg, I.DetectSpec(),
                          MEAN)
        torch.cuda.synchronize()
        if i >= 2:
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = M.default_device()
    res = {}
    for max_out in (512, 256):
        ccfg = zoo.cascade_kitti_car_7s_576_2x(deploy=True, max_out=max_out)
        ccfg = dataclasses.replace(ccfg, base=dataclasses.replace(
            ccfg.base, compute_dtype="bfloat16", pallas_conv1=True))
        params = M.cast_params(CC.init_params(torch.Generator().manual_seed(0), ccfg,
                                              device=dev), torch.bfloat16)
        h, w = ccfg.base.input_hw
        img = torch.randint(0, 256, (args.batch, h, w, 3),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.uint8).to(dev)
        ratios = torch.ones((args.batch, 2))
        orig = torch.tensor([[float(w), float(h)]] * args.batch)
        parts = stage_split(params, img, ccfg, ratios, orig, iters=args.iters)
        cum, acc = {}, 0.0
        for k in PARTS:
            acc += parts[k]
            cum[k] = acc
        res[f"max_out_{max_out}"] = {
            "ms": parts, "cumulative_ms": cum,
            "step_ms": step_ms(params, img, ccfg, ratios, orig, args.iters)}
        print(f"max_out {max_out}: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f"; step {res[f'max_out_{max_out}']['step_ms']:.2f} ms", flush=True)
        del params
        torch.cuda.empty_cache()
    res.update(device=torch.cuda.get_device_name(0), batch=args.batch,
               shape=[args.batch, 576, 1920, 3], dtype="bfloat16")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
