"""The tiny training fixture of the port's loop / CLI / import tests.

`TINY_TRAINVAL` / `TINY_SOLVER` are the texts of tests/test_loop_cli.py
(:96-155), copied; `write_dataset` writes seeded PPM images of the tiny
config's size with one bright box each and their window file, the
fixture of test_loop_cli.py's `tiny_dataset` in PPM, which the port reads
without cv2; `write_train2` adds the stage-1 cut (stage 2 without the
BoxOutput / ProposalTarget tail) and the two solver files.
"""

import numpy as np

from mscnn_torch.data import window_file as W

TINY_TRAINVAL = """
name: "tiny"
layer {{
  name: "data" type: "ImageGtData"
  include {{ phase: TRAIN }}
  transform_param {{ mirror: true mean_value: 104 mean_value: 117 mean_value: 123 }}
  image_gt_data_param {{
    source: "{source}"
    batch_size: 2
    crop_width: 96 crop_height: 64
    downsample_rate: 8 downsample_rate: 16
    field_w: 24 field_w: 48
    field_h: 24 field_h: 48
    fg_threshold: 0.5
    shuffle: true
  }}
}}
layer {{ name: "LFCN_1_5x5" type: "Convolution" bottom: "conv4_3"
  convolution_param {{ kernel_size: 5 num_output: 7 }} }}
layer {{ name: "LFCN_2_5x5" type: "Convolution" bottom: "conv5_3"
  convolution_param {{ kernel_size: 5 num_output: 7 }} }}
layer {{ name: "det_loss_1" type: "DetectionLoss" bottom: "LFCN_1_5x5"
  loss_weight: 0.9
  detection_loss_param {{
    cls_num: 3 bg_threshold: 0.2 bg_multiple: 2
    sample_mode: "bootstrap" pos_neg_weighted: true
  }} }}
layer {{ name: "proposals" type: "BoxOutput"
  bottom: "LFCN_1_5x5" bottom: "LFCN_2_5x5"
  box_output_param {{
    fg_thr: -8 iou_thr: 0.65 nms_type: "IOU" max_nms_num: 64
    field_w: 24 field_w: 48 field_h: 24 field_h: 48
    downsample_rate: 8 downsample_rate: 16
  }} }}
layer {{ name: "proposal_info" type: "ProposalTarget"
  include {{ phase: TRAIN }}
  proposal_target_param {{
    cls_num: 3 batch_size: 16 fg_fraction: 0.25
    fg_thr: 0.5 bg_thr_hg: 0.49 bg_thr_lw: 0.1
    img_width: 96 img_height: 64
  }}
  bbox_reg_param {{
    bbox_mean: 0 bbox_mean: 0 bbox_mean: 0 bbox_mean: 0
    bbox_std: 0.1 bbox_std: 0.1 bbox_std: 0.2 bbox_std: 0.2
  }} }}
"""

TINY_SOLVER = """
net: "{net}"
base_lr: 0.00005
lr_policy: "step"
gamma: 0.1
stepsize: 100
display: 1
max_iter: 2
momentum: 0.9
weight_decay: 0.0005
snapshot_prefix: "{prefix}"
random_seed: 7
"""



def stage1_cut(full):
    return full[:full.index('layer { name: "proposals"')]


def write_ppm(path, bgr):
    h, w, _ = bgr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + bgr[:, :, ::-1].tobytes())


def write_dataset(root, n=4):
    """n PPM images (64x96) and their window file; returns its path."""
    rng = np.random.RandomState(0)
    images = []
    for i in range(n):
        img = rng.randint(0, 120, (64, 96, 3)).astype(np.uint8)
        img[20:44, 30:58] = 240
        path = str(root / f"im_{i}.ppm")
        write_ppm(path, img)
        images.append(W.WindowImage(path, 3, 64, 96,
                                    np.array([[1, 0, 30, 20, 58, 44]], np.float32),
                                    np.zeros((0, 4), np.float32)))
    wf = str(root / "windows.txt")
    W.write_window_file(wf, images)
    return wf


def write_train2(root, wf, *, max_iter2=2, solver_extra=""):
    """trainval_{1st,2nd} and solver_{1st,2nd} under root; returns
    (solver1, solver2, prefix1, prefix2)."""
    full = TINY_TRAINVAL.format(source=wf)
    out = []
    for stage, text in ((1, stage1_cut(full)), (2, full)):
        net = root / f"trainval_{stage}.prototxt"
        net.write_text(text)
        prefix = str(root / f"s{stage}")
        solver = TINY_SOLVER.format(net=str(net), prefix=prefix) + solver_extra
        if stage == 2:
            solver = solver.replace("max_iter: 2", f"max_iter: {max_iter2}")
        path = root / f"solver_{stage}.prototxt"
        path.write_text(solver)
        out += [str(path), prefix]
    return out[0], out[2], out[1], out[3]
