"""Generic-net training: `cli train` on any classic prototxt.

Ports `mscnn_tpu/train/generic.py`. The reference's `caffe train` takes
any NetParameter (tools/caffe.cpp:103-233). MS-CNN nets go through the
typed config path (`config/zoo_import.py`); every other prototxt lands
here: it becomes a `models/netbuilder.py::Net`, its data layer a host
batch source, its `param` specs lr / decay multiplier trees, and one
forward / backward / solver update a step that `train/loop.py::solve`
drives as it drives the MS-CNN step: step(state, batch, *, draws=None,
generator=None) -> (state, metrics), with no host sync inside; with a
mesh, the data-parallel step of `train/train_step.py` (one rank a device).

Batch sources: ImageData, HDF5Data (io/hdf5.py, NCHW arrays to NHWC),
DummyData, WindowData and `Data` over a Caffe LMDB or LevelDB
(`io/lmdb.py`, `io/leveldb.py`; a `backend: LEVELDB` over an LMDB
environment is sniffed and read as LMDB, `_looks_like_lmdb`); MemoryData
is programmatic (`data/sources.py::MemoryDataset`). A `transform_param {
mean_file }`
raises, as does an ImageData `is_color: false`: the JAX sources ignore
both (VERDICT.md, ROADMAP Queue 3).
Batches are numpy on the host; `setup`'s batch source puts them on the
state's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mscnn_torch.config import prototxt as PB
from mscnn_torch.models import netbuilder as NB
from mscnn_torch.train import solver as S
from mscnn_torch.train import train_step as T
from mscnn_torch.train.train_step import prune_frozen_params

DATA_LAYER_TYPES = NB.DATA_LAYER_TYPES


def find_data_layer(net: NB.Net) -> Optional[dict]:
    """The net's (phase-filtered) data layer message, if any."""
    for layer in net.layers:
        if str(layer.get("type")) in DATA_LAYER_TYPES:
            return layer
    return None


def _looks_like_lmdb(path: str) -> bool:
    """MDB_MAGIC (0xBEEFC0DE LE) at offset 16 of data.mdb — lets a
    misdeclared `backend: LEVELDB` that actually points at an LMDB env
    (common in recycled prototxts) still load."""
    import os
    p = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
    try:
        with open(p, "rb") as f:
            head = f.read(20)
    except OSError:
        return False
    return head[16:20] == b"\xde\xc0\xef\xbe"


def _nchw_to_nhwc(a: np.ndarray) -> np.ndarray:
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _transform_spec(layer: dict, crop: bool = True):
    """`sources.TransformSpec` of a layer's transform_param; a mean_file
    (a per-pixel mean BlobProto, data_transformer.cpp:33-75) is refused:
    the JAX sources read mean_value only (generic.py:83-86)."""
    from mscnn_torch.data import sources as SRC

    tp = layer.get("transform_param", {})
    if "mean_file" in tp:
        raise ValueError(
            f"layer {layer.get('name')!r}: transform_param.mean_file is "
            "ignored by the reference's sources (mscnn_tpu/train/"
            "generic.py:83-86); the port refuses it (ROADMAP Queue 3): "
            "give mean_value instead")
    mv = [float(v) for v in PB.as_list(tp.get("mean_value"))]
    return SRC.TransformSpec(
        scale=float(tp.get("scale", 1.0)),
        mean_values=tuple(mv) if mv else None,
        crop_size=int(tp.get("crop_size", 0)) if crop else 0,
        mirror=bool(tp.get("mirror", False))), tp


def make_batch_source(net: NB.Net, layer: dict, *, seed: int = 0,
                      train: bool = True, root_folder: str = "",
                      batch_size: Optional[int] = None
                      ) -> Callable[[], Dict]:
    """Host batch source for one data layer: () -> {top: np.ndarray},
    images NHWC (image_data_layer.cpp, hdf5_data_layer.cpp,
    dummy_data_layer.cpp, window_data_layer.cpp). batch_size overrides
    the layer's (the CLI's --batch-size; for DummyData every top's leading
    dim)."""
    from mscnn_torch.data import sources as SRC

    ltype = str(layer.get("type"))
    tops = [str(t) for t in PB.as_list(layer.get("top"))]

    if ltype == "ImageData":
        ip = layer.get("image_data_param", {})
        if not bool(ip.get("is_color", True)):
            raise ValueError(
                f"layer {layer.get('name')!r}: image_data_param.is_color: "
                "false is ignored by the reference's sources (every image is "
                "read in colour, mscnn_tpu/data/pipeline.py::load_image); the "
                "port refuses it (ROADMAP Queue 3)")
        tspec, _ = _transform_spec(layer)
        ds = SRC.ImageListDataset(
            str(ip["source"]), batch_size or int(ip.get("batch_size", 1)),
            tspec, root_folder=str(ip.get("root_folder", root_folder)),
            # caffe.proto ImageDataParameter.shuffle default = false
            shuffle=bool(ip.get("shuffle", False)), seed=seed, train=train)

        def source():
            b = ds.next_batch()
            out = {tops[0]: b["image"]}
            if len(tops) > 1:
                out[tops[1]] = b["label"]
            return out

        return source

    if ltype == "HDF5Data":
        hp = layer.get("hdf5_data_param", {})
        with open(str(hp["source"])) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        ds = SRC.HDF5Dataset(files, batch_size or int(hp.get("batch_size", 1)),
                             shuffle=bool(hp.get("shuffle", False)), seed=seed)

        def source():
            b = ds.next_batch()
            return {t: _nchw_to_nhwc(b[t]) for t in tops if t in b}

        return source

    if ltype == "DummyData":
        dp = layer.get("dummy_data_param", {})
        sh_list = PB.as_list(dp.get("shape"))
        fillers = PB.as_list(dp.get("data_filler"))
        shapes = []
        for ti in range(len(tops)):
            if sh_list:
                dims = [int(d) for d in PB.as_list(
                    sh_list[min(ti, len(sh_list) - 1)]["dim"])]
            else:   # legacy num / channels / height / width fields
                def leg(name):
                    vals = PB.as_list(dp.get(name))
                    return int(vals[min(ti, len(vals) - 1)]) if vals else 1
                dims = [leg("num"), leg("channels"), leg("height"),
                        leg("width")]
            shapes.append(NB._nhwc(dims))
        if batch_size:
            shapes = [(batch_size,) + tuple(sh[1:]) for sh in shapes]
        rng = np.random.RandomState(seed)

        def source():
            out = {}
            for ti, t in enumerate(tops):
                fp = fillers[min(ti, len(fillers) - 1)] if fillers else {}
                ftype = str(fp.get("type", "constant"))
                if ftype == "gaussian":
                    a = rng.randn(*shapes[ti]).astype(np.float32) \
                        * float(fp.get("std", 1.0)) + float(fp.get("mean", 0.0))
                elif ftype == "uniform":
                    a = rng.uniform(float(fp.get("min", 0.0)),
                                    float(fp.get("max", 1.0)),
                                    shapes[ti]).astype(np.float32)
                else:
                    a = np.full(shapes[ti], float(fp.get("value", 0.0)),
                                np.float32)
                out[t] = a
            return out

        return source

    if ltype == "WindowData":
        from mscnn_torch.data import window_file as W
        wp = layer.get("window_data_param", {})
        tspec, tp = _transform_spec(layer, crop=False)
        images = W.parse_window_file(
            str(wp["source"]),
            root_folder=str(wp.get("root_folder", root_folder)))
        ds = SRC.WindowCropDataset(
            images,
            crop_size=int(tp.get("crop_size", wp.get("crop_size", 227))),
            fg_fraction=float(wp.get("fg_fraction", 0.25)),
            fg_thr=float(wp.get("fg_threshold", 0.5)),
            bg_thr=float(wp.get("bg_threshold", 0.5)),
            context_pad=int(wp.get("context_pad", 0)),
            batch_size=batch_size or int(wp.get("batch_size", 32)),
            seed=seed, tspec=tspec)

        def source():
            b = ds.next_batch()
            out = {tops[0]: b["image"]}
            if len(tops) > 1:
                out[tops[1]] = b["label"]
            return out

        return source

    if ltype == "Data":
        # data_layer.cpp + data_reader.cpp: sequential Datum records, LMDB
        # by io/lmdb.py, LevelDB by io/leveldb.py. The declared backend is
        # cross-checked against the files (recycled prototxts often say
        # LEVELDB over an LMDB environment).
        from mscnn_torch.io import leveldb as LDB
        dp = layer.get("data_param", {})
        backend = str(dp.get("backend", "LEVELDB")).upper()
        src_path = str(dp["source"])
        if _looks_like_lmdb(src_path):
            backend = "LMDB"
        elif LDB.is_leveldb_dir(src_path):
            backend = "LEVELDB"
        elif backend not in ("LMDB", "LEVELDB"):
            raise ValueError(f"unknown Data backend {backend!r}")
        tspec, _ = _transform_spec(layer)
        cls = SRC.LMDBDataset if backend == "LMDB" else SRC.LevelDBDataset
        ds = cls(src_path, batch_size or int(dp.get("batch_size", 1)),
                 tspec=tspec, seed=seed)

        def source():
            b = ds.next_batch(train=train)
            out = {tops[0]: b["data"]}
            if len(tops) > 1:
                out[tops[1]] = b["label"]
            return out

        return source
    raise ValueError(f"unsupported data layer type {ltype!r} for generic "
                     "training (MemoryData is programmatic-only)")


def param_multipliers(net: NB.Net, params: dict) -> Tuple[dict, dict]:
    """{layer: {leaf: float}} lr / decay multipliers from `param` specs
    (caffe.proto ParamSpec lr_mult / decay_mult; default 1.0), by blob
    position, so a blob shared away keeps the next spec on its own blob."""
    lr = {n: {k: 1.0 for k in p} for n, p in params.items()}
    dk = {n: {k: 1.0 for k in p} for n, p in params.items()}
    for layer in net.layers:
        name = str(layer.get("name"))
        if name not in params:
            continue
        specs = [s for s in PB.as_list(layer.get("param"))
                 if isinstance(s, dict)]
        keys = NB._SHARE_KEYS.get(str(layer.get("type")), ("w", "b"))
        for i, k in enumerate(keys[:len(specs)]):
            if k in params[name]:
                lr[name][k] = float(specs[i].get("lr_mult", 1.0))
                dk[name][k] = float(specs[i].get("decay_mult", 1.0))
    return lr, dk


def _acc_tops(net: NB.Net):
    return [str(PB.as_list(l.get("top"))[0]) for l in net.layers
            if str(l.get("type")) == "Accuracy"]


def make_train_step(net: NB.Net, sspec: S.SolverSpec, *, lr_mults=None,
                    decay_mults=None, mesh=None):
    """step(state, batch, *, draws=None, generator=None) -> (state,
    metrics): forward through `net.apply` (losses in blobs["loss"]),
    autograd backward, the solver's update. lr_mult-0 leaves get no
    gradient (`train_step.prune_frozen_params`, net.cpp:191-247). draws /
    generator: the Dropout / STOCHASTIC draws (`Net.apply`). mesh:
    P2PSync-style data parallelism as in `train_step.make_train_step`: this
    rank's micro-batch and draws, the gradients and metrics averaged over
    the ranks, the same update on every rank."""
    acc_tops = _acc_tops(net)
    if mesh is not None:
        T.mesh_rank(mesh)

    def step(state, batch, *, draws=None, generator=None):
        params = state["params"]
        leaves = prune_frozen_params(params, lr_mults)
        blobs = net.apply(leaves, batch, train=True, draws=draws,
                          generator=generator)
        loss = blobs["loss"]
        names = [(n, k) for n, p in leaves.items() for k, v in p.items()
                 if v.requires_grad]
        got = torch.autograd.grad(loss, [leaves[n][k] for n, k in names],
                                  allow_unused=True)
        grads = {n: {k: None for k in p} for n, p in params.items()}
        for (n, k), g in zip(names, got):
            grads[n][k] = g
        metrics = {"loss": loss.detach()}
        metrics.update({t: blobs[t].detach() for t in acc_tops if t in blobs})
        if mesh is not None:
            grads, metrics = T._mean_over_ranks(params, grads, metrics,
                                                lr_mults)
        new_params, sstate, lr = S.apply_update(
            params, grads, state["solver"], sspec, lr_mults, decay_mults)
        metrics["lr"] = lr
        return {"params": new_params, "solver": sstate}, metrics

    return step


def make_eval_step(net: NB.Net, mesh=None):
    """(params, batch, *, draws=None, generator=None) -> {metric}: the
    TEST-phase net's loss and Accuracy tops (caffe test); with a mesh,
    this rank's batch and the metrics averaged over the ranks."""
    acc_tops = _acc_tops(net)
    if mesh is not None:
        T.mesh_rank(mesh)

    @torch.no_grad()
    def eval_step(params, batch, *, draws=None, generator=None):
        blobs = net.apply(params, batch, train=False)
        out = {"loss": blobs["loss"]}
        out.update({t: blobs[t] for t in acc_tops if t in blobs})
        if mesh is not None:
            _, out = T._mean_over_ranks({}, {}, out, None)
        return out

    return eval_step


def setup(net_path: str, sspec: S.SolverSpec, *, phase: str = "TRAIN",
          seed: int = 0, weights: Optional[str] = None, mesh=None,
          batch_size: Optional[int] = None, device=None):
    """(state, step, batch_source, net) for a generic prototxt.

    The input shapes come from one probe batch of the data layer (the
    reference reshapes from its first prefetched batch,
    base_data_layer.cpp). weights: a warm-start `.caffemodel` (with the
    net's structural layout hints) or snapshot directory. Params are drawn
    from a generator seeded `seed` and live on `device`, by default the
    card (raises without one); batch_source() returns the next batch on
    that device. With a mesh (a rank of data parallelism), the Net keeps
    the global batch's shapes as JAX's does, the state is this rank's
    replica of rank 0's, the step is the mesh step, and batch_source()
    returns this rank's rows of the global batch; the data layer's batch
    must divide the mesh (JAX's ValueError)."""
    from mscnn_torch.io import caffemodel as CM
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models.mscnn import default_device

    dev = default_device() if device is None else torch.device(device)
    probe_net = NB.Net(net_path, phase=phase)
    layer = find_data_layer(probe_net)
    if layer is None:
        raise ValueError(
            f"net {net_path!r} has no {phase}-phase data layer "
            f"({'/'.join(DATA_LAYER_TYPES)}) and no MSCNN ImageGtData: "
            "nothing to train from")
    source = make_batch_source(probe_net, layer, seed=seed,
                               train=phase == "TRAIN", batch_size=batch_size)
    first = source()
    if mesh is not None:
        n_dev = mesh.size
        bs = next(iter(first.values())).shape[0]
        if bs % n_dev:
            raise ValueError(f"data-layer batch_size {bs} not divisible "
                             f"by {n_dev} devices")
        dev = T.mesh_rank(mesh)[1]
    net = NB.Net(net_path, phase=phase,
                 input_shapes={k: tuple(v.shape) for k, v in first.items()})
    params = net.init(torch.Generator().manual_seed(seed), device=dev)
    if weights:
        params = CKPT.restore_params(weights, params,
                                     layout_hints=CM.net_layout_hints(net),
                                     layouts=net.param_layouts())
    lr_mults, decay_mults = param_multipliers(net, params)
    step = make_train_step(net, sspec, lr_mults=lr_mults,
                           decay_mults=decay_mults, mesh=mesh)
    state = {"params": params, "solver": S.init_state(params, sspec)}
    pending = [first]
    if mesh is not None:
        state = T.replicate_state(state, mesh)

        def batch_source():
            return T.shard_batch(pending.pop() if pending else source(), mesh)

        return state, step, batch_source, net

    def batch_source():
        b = pending.pop() if pending else source()
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            dev, non_blocking=True) for k, v in b.items()}

    return state, step, batch_source, net
