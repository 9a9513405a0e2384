"""Ahead-of-time deploy artifact: the serving graph as a `torch.export`
program, written next to the weights.

Ports `mscnn_tpu/io/aot.py` (`save_params`, `load_params`,
`export_deploy`, `CompiledDeploy`, `load_deploy`; JAX's
`make_batched_e2e` and `make_cascade_e2e` are `inference.e2e_outputs`
and `inference.cascade_e2e_outputs` here, batched already). The whole
traced program -- trunk, heads, decode, NMS and per-class
post-processing -- is exported once with `torch.export` and saved
with `torch.export.save`. The hand-written kernels K1, K2 and K4 are single
nodes of that graph (`mscnn.nms_xywh`, `mscnn.conv1_pool`,
`mscnn.int8_conv`, the operators of `ops/kernels/ops.py`), as the JAX
artifact captures the Pallas NMS kernel when it exports on the TPU. A
serving host loads the artifact and calls it without any model code: this
module's loading half imports `ops/kernels/ops.py` (to register the
operators) and `data/resize.py`, and nothing under `mscnn_torch/models/`.

Artifact layout (one directory):
  deploy.pt2         torch.export.save of the ExportedProgram
  params.npz         flat param leaves as raw little-endian byte arrays
  params_meta.json   per-leaf path / dtype / shape (bf16 and int8 survive)
  meta.json          format, torch version, platforms, input geometry,
                     batch, mean values, DetectSpec

The params are an input of the program, not constants in it; its input
shapes are static (batch, H and W fixed, as in the JAX artifact): images
[B, H, W, 3] uint8, ratios [B, 2] and orig_wh [B, 2] float32, with B =
meta["batch"] (1 included). The weight files have JAX's layout: the port
reads a JAX artifact's params.npz / params_meta.json (and `io/bridge.py`
converts the leaves), without ml_dtypes.

Where the port differs: `jax.export` can lower for a platform the exporting
host lacks (a TPU artifact from a CPU host). A torch program is traced on
the device it will run on, with that device in its graph: `platforms` names
one device type, the params go there before the trace, and "cuda" without a
card raises.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mscnn_torch.data.resize import resize_bilinear_u8
from mscnn_torch.ops.kernels import ops as _ops  # noqa: F401  (registers mscnn::*)

FORMAT = "mscnn-torch-aot-v1"
PLATFORMS = ("cuda", "cpu")


def _flatten(params, prefix=()) -> list:
    """-> [(path_parts, tensor)] in the dicts' order; the key path is kept
    as a LIST so layer names containing any separator character (Caffe
    allows e.g. 'inception_3a/1x1') round-trip exactly."""
    if isinstance(params, dict):
        out = []
        for k, v in params.items():
            out += _flatten(v, prefix + (str(k),))
        return out
    return [(list(prefix), params)]


def _leaf_bytes(t) -> tuple:
    """(numpy's name of the dtype, shape, raw bytes) of a tensor leaf."""
    t = t.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
        np.zeros(0, np.uint8)
    return str(t.dtype).replace("torch.", ""), list(t.shape), raw


def save_params(params, npz_path: str, meta_path: str) -> int:
    """Write param leaves as raw bytes (index-named npz entries) + a
    path/dtype/shape sidecar (npz alone cannot hold bfloat16, and npz entry
    names cannot carry arbitrary layer names). Returns the leaf count."""
    flat = [(parts, _leaf_bytes(v)) for parts, v in _flatten(params)]
    meta = [{"path": parts, "dtype": dt, "shape": shape}
            for parts, (dt, shape, _) in flat]
    np.savez(npz_path, **{f"p{i}": raw for i, (_, (_, _, raw)) in enumerate(flat)})
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return len(flat)


def load_params(npz_path: str, meta_path: str, device=None):
    """The nested {layer: {leaf: tensor}} dict `save_params` wrote (the
    JAX package's files too), every leaf a tensor of its dtype (bfloat16
    by its bytes: no ml_dtypes) on `device` (default CPU)."""
    with open(meta_path) as f:
        meta = json.load(f)
    raw = np.load(npz_path)
    root: dict = {}
    for i, m in enumerate(meta):
        dtype = getattr(torch, m["dtype"])
        b = raw[f"p{i}"]
        t = torch.from_numpy(b.copy()).view(dtype) if b.size else \
            torch.empty(0, dtype=dtype)
        t = t.reshape(m["shape"])
        if device is not None:
            t = t.to(device)
        node = root
        for p in m["path"][:-1]:
            node = node.setdefault(p, {})
        node[m["path"][-1]] = t
    return root


class _Program(torch.nn.Module):
    """The module `torch.export` traces: no parameters of its own (the
    params are its first input)."""

    def __init__(self, fwd):
        super().__init__()
        self.fwd = fwd

    def forward(self, params, imgs_u8, ratios, orig_wh):
        return self.fwd(params, imgs_u8, ratios, orig_wh)


def _target_device(params, platforms) -> torch.device:
    from mscnn_torch.models import mscnn as M

    dev = M.params_device(params)
    if not platforms:
        return dev
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"platforms {list(platforms)}: a torch program runs on "
                         f"one device type, one of {PLATFORMS}")
    if platforms[0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platforms cuda: no CUDA device here. A torch program is traced "
            "on the device it will run on; export it on a machine with a card "
            "(the JAX artifact can be lowered for a TPU from a CPU host, this "
            "one cannot)")
    return torch.device(platforms[0]) if platforms[0] != dev.type else dev


def export_deploy(params, cfg, out_dir: str, *, spec=None,
                  mean_values=(104.0, 117.0, 123.0),
                  platforms: Optional[Sequence[str]] = None,
                  batch: int = 1, cascade=None) -> str:
    """Trace the serving graph (uint8 net-size images -> final per-class
    detections) with `torch.export` and write the artifact directory.
    Returns out_dir.

    platforms: one device type ("cuda" or "cpu"; default: the params'
    device); the params move there first. batch: images per serving call
    (static). cascade: a CascadeConfig for staged models (then cfg must be
    cascade.base): the detect_cascade semantics in one program.
    """
    from mscnn_torch import inference as I

    spec = spec or I.DetectSpec()
    dev = _target_device(params, platforms)
    params = {name: {k: v.to(dev) for k, v in p.items()}
              for name, p in params.items()}
    os.makedirs(out_dir, exist_ok=True)
    net_h, net_w = cfg.input_hw
    # the serving graph: f(params, images [B, H, W, 3] uint8, ratios [B, 2],
    # orig_wh [B, 2]) -> per-image final detections and proposals
    if cascade is None:
        fwd = functools.partial(I.e2e_outputs, cfg=cfg, spec=spec,
                                mean_values=mean_values)
    else:
        fwd = functools.partial(I.cascade_e2e_outputs, ccfg=cascade, spec=spec,
                                mean_values=mean_values)
    args = (params,
            torch.zeros((batch, net_h, net_w, 3), dtype=torch.uint8, device=dev),
            torch.ones((batch, 2), dtype=torch.float32, device=dev),
            torch.tensor([[float(net_w), float(net_h)]] * batch, device=dev))
    with torch.no_grad():
        program = torch.export.export(_Program(fwd), args, strict=False)
    # the example inputs hold the params: they go to params.npz, once
    program.example_inputs = None
    torch.export.save(program, os.path.join(out_dir, "deploy.pt2"))
    n = save_params(params, os.path.join(out_dir, "params.npz"),
                    os.path.join(out_dir, "params_meta.json"))
    meta = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": [dev.type],
        "input_hw": [int(net_h), int(net_w)],
        "batch": int(batch),
        "cascade": cascade is not None,
        "num_classes": int(cfg.num_classes),
        "mean_values": [float(m) for m in mean_values],
        "detect_spec": {
            "proposal_thr": spec.proposal_thr,
            "nms_overlap": spec.nms_overlap,
            "nms_mode": spec.nms_mode,
            "max_per_class": spec.max_per_class,
            "score_thr": spec.score_thr,
        },
        "kernel_ops": kernel_ops(program),
        "param_leaves": n,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def kernel_ops(program) -> dict:
    """{operator: node count} of the `mscnn::` operators in an exported
    program's graph."""
    found: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("mscnn."):
            found[name] = found.get(name, 0) + 1
    return found


def _pinned(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class CompiledDeploy:
    """A loaded artifact: callable serving endpoint + metadata.

    `detect(image_bgr)` mirrors inference.detect()'s output dict (boxes /
    scores / valid in original-image coordinates, the rescaled proposals)
    but runs entirely from the exported program -- no model code, configs
    or prototxts on the serving host. The program runs on the device it
    was exported for (meta["platforms"]); `device` may name another index
    of that type.
    """

    def __init__(self, out_dir: str, device=None):
        with open(os.path.join(out_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{out_dir}: format {self.meta.get('format')!r}, "
                             f"not {FORMAT!r}")
        self.device = torch.device(device or self.meta["platforms"][0])
        if self.device.type != self.meta["platforms"][0]:
            raise ValueError(f"{out_dir} was exported for "
                             f"{self.meta['platforms'][0]}, not {self.device}")
        self.program = torch.export.load(os.path.join(out_dir, "deploy.pt2"))
        self._fn = self.program.module()
        self.params = load_params(os.path.join(out_dir, "params.npz"),
                                  os.path.join(out_dir, "params_meta.json"),
                                  device=self.device)
        self.batch = int(self.meta.get("batch", 1))

    def __call__(self, img_u8, ratios, orig_wh):
        """images [B, H, W, 3] uint8, ratios and orig_wh [B, 2] float32, on
        the artifact's device -> the dict of device tensors."""
        with torch.inference_mode():
            return self._fn(self.params, img_u8, ratios, orig_wh)

    def _prep(self, image_bgr: np.ndarray):
        net_h, net_w = self.meta["input_hw"]
        oh, ow = image_bgr.shape[:2]
        return (resize_bilinear_u8(image_bgr, (net_w, net_h)),
                np.asarray([net_h / oh, net_w / ow], np.float32),
                np.asarray([ow, oh], np.float32))

    def inputs(self, preps):
        """The program's inputs for a full group of `_prep` results, on the
        device (from pinned memory on a card)."""
        return tuple(_pinned(np.stack([p[j] for p in preps]), self.device)
                     for j in range(3))

    @staticmethod
    def _result(out, i, ratios) -> dict:
        props = np.asarray(out["rois"][i], np.float64).copy()
        props[:, [0, 2]] /= float(ratios[1])
        props[:, [1, 3]] /= float(ratios[0])
        return {
            "boxes": out["boxes"][i],
            "scores": out["scores"][i],
            "valid": out["valid"][i],
            "proposals": props,
            "proposal_scores": out["roi_scores"][i],
            "proposal_valid": out["roi_valid"][i],
        }

    def detect(self, image_bgr: np.ndarray) -> dict:
        return self.detect_many([image_bgr])[0]

    def detect_many(self, images_bgr) -> list:
        """Serving call(s), `batch` images each: pads the tail group by
        repeating the last image (batch is static in the program)."""
        preps = [self._prep(im) for im in images_bgr]
        results = []
        for g0 in range(0, len(preps), self.batch):
            grp = preps[g0:g0 + self.batch]
            full = grp + [grp[-1]] * (self.batch - len(grp))
            out = self(*self.inputs(full))
            # one device-to-host copy an output a group
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for i, p in enumerate(grp):
                results.append(self._result(out, i, p[1]))
        return results


def load_deploy(out_dir: str, device=None) -> CompiledDeploy:
    return CompiledDeploy(out_dir, device=device)
