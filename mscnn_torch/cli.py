"""Command-line interface: the `caffe <command>` equivalent.

Ports `mscnn_tpu/cli.py`: `train` and the two-step `train2`
(`_apply_conv1`, `_build_training`, cli.py:24-230), the deploy commands
`test`, `time`, `detect`, `parity`, `eval`, `export`, `compile`, `serve`
and `device_query` (`cmd_test` :233, `cmd_time` :337, `_int8_quantize`
:489, `_int8_quantize_heads` :530, `cmd_detect` :546, `cmd_parity` :792,
`cmd_eval` :879, `cmd_export` :939, `cmd_compile` :973, `cmd_serve` :1044,
`cmd_device_query` :1269), `_add_common` and `main` (:1276-1589), for the
MS-CNN nets (VGG16 trunk, LFCN heads, BoxOutput, ROI head) and the
cascades the reference's model zoo ships:

    python -m mscnn_torch.cli train2 --solver1 solver_1st.prototxt \\
        --solver2 solver_2nd.prototxt --bf16 --uint8-input
    python -m mscnn_torch.cli detect --zoo kitti_car/mscnn-8s-768-trainval \\
        --weights w.caffemodel --bf16 --image-dir image_2 --output-dir out
    python -m mscnn_torch.cli compile --bf16 --batch 4 -o artifact
    python -m mscnn_torch.cli serve --compiled artifact --port 8437

Every command runs on the card unless `--device cpu` asks for the CPU;
with no card and no such request it raises. `--conv1 auto` picks the
fused conv1 kernel (`pallas_conv1`, K2) on a card at bf16 unless `--int8`
is set, as the JAX CLI picks its Pallas kernel on a TPU. A cascade
prototxt or zoo entry routes to the cascade (`models/cascade.py`), with
`--bf16` and `--conv1` applied to it too. Images are decoded by
`data/image_io.py` (JPEG, PNG, PPM and PGM without cv2) and resized by
`data/resize.py` (cv2's INTER_LINEAR, bit for bit). An artifact from
`compile` is a `torch.export` program (`io/aot.py`) and runs on the device
type it was exported on. `train` / `train2` read their window file or
record shard (`data/records.py`) through the worker loader
(`data/native_loader.py`: one worker process a core of the host, no more
than its slots), as the JAX CLI reads through its C++ loader;
`--no-native` takes the one-thread pipeline.

A solver whose net is not an MS-CNN prototxt (no ImageGtData) trains and
tests through the generic net builder (`_build_generic_training`,
`train/generic.py`), as `caffe train` takes any net; `time --layers
--model net.prototxt` times each layer of such a net alone (`_time_layers`,
cli.py:255-335), with CUDA events on the card.

The dataset tools `convert_imageset` (an image list or window file to a
record shard, an LMDB or a LevelDB, raw or re-encoded as PNG or JPEG; a
Caffe database to a record shard), `compute_mean`, `resize_images` and
`extract_features` are `cmd_convert_imageset` / `cmd_compute_mean` /
`cmd_resize_images` / `cmd_extract_features` (cli.py:1169-1182,
:1220-1232, :1053-1072, :1235-1266) over `tools.py`; `extract_features`
runs the trunk and heads of --model / --zoo (a cascade's base) in
float32 on the card and writes HDF5 (`io/hdf5.py`). The prototxt
tools `summary` (shapes from the generic net builder's `Net.init` on
--device), `draw` (Graphviz DOT, `utils/draw.py`), `upgrade_net_proto` /
`upgrade_solver_proto` (`config/upgrade.py`) and `plot_log` (a PNG of a
training log, `utils/parse_log.py`; it needs matplotlib) and the Caltech
`vbb2bbgt` converter are cli.py:1075-1166 and :1184-1217.

`--devices N` (data parallelism, ROADMAP item 20): `train`, `train2` and
`test` spawn N ranks (`torch.multiprocessing`, spawn start method; one
process a device, `_rank_main`) on cuda:0 .. cuda:N-1 over NCCL, or on
the CPU over gloo with `--device cpu`; each rank reads its rows of every
batch (`data/native_loader.py`'s `part`), steps on its micro-batch, and
all-reduces its gradients (`train/train_step.py`); rank 0 prints and
writes the snapshots. `detect` and `parity` run one process that drives
the N devices (`inference.py::MeshForward`), as the JAX CLI's one
controller drives its mesh. The batch must divide N (JAX's message), and N
devices must exist ("mesh shape (N,) needs N devices, have M"). `time`,
`compile` and `extract_features` take `--devices` as the JAX CLI's do,
where it is ignored; the port refuses N > 1 there rather than ignore it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time as _time

import numpy as np
import torch


def _device(args) -> torch.device:
    """The card unless --device names another device; raises without a
    card (models/mscnn.py::default_device)."""
    from mscnn_torch.models import mscnn as M

    return M.default_device() if args.device is None else torch.device(args.device)


def _apply_conv1(cfg, args, device):
    """Resolve the --conv1 strategy flag onto a config. auto = the fused
    conv1 kernel on a card at bf16, except when the int8 trunk is
    requested (the conv1 pair quantizes with the rest of the trunk). The
    kernel computes in bf16, so an explicit 'pallas' at f32 compute is
    rejected rather than silently degrading precision."""
    conv1 = getattr(args, "conv1", "auto") or "auto"
    if conv1 == "auto":
        conv1 = "pallas" if (torch.device(device).type == "cuda"
                             and cfg.compute_dtype == "bfloat16"
                             and not getattr(args, "int8", False)) else "plain"
    elif conv1 == "pallas" and cfg.compute_dtype != "bfloat16":
        raise SystemExit("--conv1 pallas requires --bf16 (the fused "
                         "kernel computes in bfloat16)")
    return dataclasses.replace(cfg, pallas_conv1=conv1 == "pallas",
                               s2d_conv1=conv1 == "s2d")


def _cascade_objective(params, batch, cfg, tspec, *, ccfg, roi_batch, draws,
                       generator, mark):
    """The cascade's loss with `make_train_step`'s objective signature."""
    from mscnn_torch.models import cascade as CC

    return CC.loss_fn(params, batch, ccfg, tspec, roi_batch=roi_batch,
                      draws=draws, generator=generator, mark=mark)


class _PlainSource:
    """A batch function as a context manager with `get`, the loaders'
    interface (`with make_batch_source() as src: src.get()`)."""

    def __init__(self, fn):
        self.get = fn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _build_generic_training(args, fields, net_path, sspec, lspec):
    """Generic (non-MS-CNN) prototxt training through `train/generic.py`:
    the `_build_training` tuple with cfg None (the generic marker) and the
    Net in the tspec slot (`cmd_test` builds its eval step from it)."""
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.train import generic as G

    if args.bf16:
        raise SystemExit("--bf16 applies to the MSCNN compute-dtype "
                         "config; generic prototxt nets run f32")
    if getattr(args, "uint8_input", False):
        raise SystemExit("--uint8-input is the ImageGtData loader path; "
                         "generic prototxt nets read their own data "
                         "layers (no silent fallback)")
    mesh = _devices_mesh(args)
    state, step, batch_source, net = G.setup(
        net_path, sspec, phase=getattr(args, "phase", "TRAIN") or "TRAIN",
        seed=int(fields.get("random_seed", 0)), weights=args.weights or None,
        batch_size=args.batch_size or None, device=_device(args), mesh=mesh)
    if args.snapshot:   # every rank reads the same snapshot
        state = CKPT.restore(args.snapshot, state)
    lspec = dataclasses.replace(lspec, param_layouts=tuple(
        (n, t, g) for n, (t, g) in net.param_layouts().items()))
    return (state, step, lambda: _PlainSource(batch_source), lspec, None,
            net)


def _build_training(args, solver_path):
    """(state, step, make_batch_source, loop spec, cfg, tspec) of a solver
    prototxt and the net it names (cfg None and the Net as tspec for a
    generic prototxt)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.config import zoo_import as Z
    from mscnn_torch.data import native_loader as NL
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train import solver as S
    from mscnn_torch.train import train_step as T

    fields = PB.parse_prototxt_file(solver_path)
    sspec = S.spec_from_prototxt_fields(fields)
    lspec = LP.loop_spec_from_solver_fields(
        fields, snapshot_prefix=args.snapshot_prefix)
    net_path = args.model or os.path.join(
        os.path.dirname(solver_path), str(fields["net"]))
    ccfg = None
    if Z.is_cascade_prototxt(net_path):
        ccfg, tspec, aug, dspec, source = Z.cascade_from_prototxt(net_path)
        cfg = ccfg.base
    else:
        try:
            cfg, tspec, aug, dspec, source = Z.model_from_prototxt(
                net_path, phase=getattr(args, "phase", "TRAIN"))
        except ValueError as e:
            if "ImageGtData" not in str(e):
                raise
            # not an MS-CNN net: generic-prototxt training (caffe train
            # accepts any NetParameter, tools/caffe.cpp:103-233)
            return _build_generic_training(args, fields, net_path, sspec,
                                           lspec)
    if args.batch_size:
        dspec = dataclasses.replace(dspec, batch_size=args.batch_size)
    _check_batch(dspec.batch_size, args.devices)
    mesh = _devices_mesh(args)
    if args.bf16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    dev = _device(args)
    cfg = _apply_conv1(cfg, args, dev)
    if args.uint8_input:
        # raw uint8 canvases + normalisation on the device (bit-identical,
        # 4x less host-to-device traffic)
        aug = dataclasses.replace(aug, emit_uint8=True)
        tspec = T.sync_input_norm(tspec, aug)
    window_file = args.window_file or os.path.join(
        os.path.dirname(net_path), source)

    gen = torch.Generator().manual_seed(int(fields.get("random_seed", 0)))
    loss_function = None
    if ccfg is not None:
        from mscnn_torch.models import cascade as CC

        # the objective gets the config --bf16 / --conv1 made (the JAX CLI
        # binds the imported one, ROADMAP Queue 3)
        ccfg = dataclasses.replace(ccfg, base=cfg)
        loss_function = functools.partial(_cascade_objective, ccfg=ccfg,
                                          roi_batch=tspec.roi_batch)
        params = CC.init_params(gen, ccfg, device=dev)
        lr_mults = CC.param_lr_multipliers(params, ccfg)
    else:
        params = M.init_params(gen, cfg, device=dev)
        lr_mults = M.param_lr_multipliers(params, cfg)
    if args.weights:   # warm start: the snapshot's layers by name
        params = CKPT.restore_params(args.weights, params)
    state = {"params": params, "solver": S.init_state(params, sspec)}
    if args.snapshot:   # every rank reads the same snapshot
        state = CKPT.restore(args.snapshot, state)
    if mesh is not None:
        state = T.replicate_state(state, mesh)
    step = T.make_train_step(cfg, tspec, sspec, lr_mults=lr_mults,
                             decay_mults=M.param_decay_multipliers(params, cfg),
                             mesh=mesh, loss_function=loss_function)

    # one worker a core the process may run on (shared by the host's ranks),
    # no more than the loader's slots (queue_depth 3 batches of this rank's
    # rows): decoding and rendering bound the loop
    n = mesh.size if mesh is not None else 1
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    workers = max(min(cores // n, 3 * dspec.batch_size // n), 1)
    part = (args.rank, n) if mesh is not None else None

    def make_batch_source():
        return NL.make_loader(window_file, aug, dspec,
                              root_folder=args.root_folder, device=dev,
                              prefer_native=not getattr(args, "no_native",
                                                        False),
                              num_workers=workers, queue_depth=3, part=part)

    return state, step, make_batch_source, lspec, cfg, tspec


def _rank(args):
    """This process's rank of a data-parallel run, None outside one."""
    return getattr(args, "rank", None)


def _check_batch(batch_size, n):
    if n > 1 and batch_size % n:
        raise SystemExit(f"batch_size {batch_size} not divisible by {n} devices")


def _devices_mesh(args):
    """The mesh of --devices N (N devices must exist; SystemExit with
    make_mesh's message otherwise), or None for N = 1. A training mesh
    takes its ranks' process group (`_spawn_ranks`)."""
    from mscnn_torch.parallel import data_parallel_mesh

    n = int(getattr(args, "devices", 1) or 1)
    if n <= 1:
        return None
    if args.device is None:
        _device(args)       # no card and no --device: raises, as everywhere
    try:
        return data_parallel_mesh(n, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _precheck_batch(args, solver_path):
    """The divisibility check of an MS-CNN solver's batch, in the parent
    before any rank starts (a generic net's is its data layer's, which the
    ranks check)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.config import zoo_import as Z

    fields = PB.parse_prototxt_file(solver_path)
    net_path = args.model or os.path.join(os.path.dirname(solver_path),
                                          str(fields["net"]))
    try:
        if Z.is_cascade_prototxt(net_path):
            dspec = Z.cascade_from_prototxt(net_path)[3]
        else:
            dspec = Z.model_from_prototxt(
                net_path, phase=getattr(args, "phase", "TRAIN"))[3]
    except ValueError as e:
        if "ImageGtData" not in str(e):
            raise
        return
    _check_batch(args.batch_size or dspec.batch_size, args.devices)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank, cmd, argd, port, n, threads):
    """One rank of `--devices N`: its device (cuda:rank, or the CPU), the
    process group, then the command with args.rank set."""
    from mscnn_torch.parallel import distributed as D

    args = argparse.Namespace(**argd, rank=rank)
    if args.device is not None and torch.device(args.device).type != "cuda":
        args.device = str(torch.device(args.device))
    else:
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    if threads:
        torch.set_num_threads(threads)
    D.initialize(f"127.0.0.1:{port}", n, rank, device=args.device)
    try:
        rc = _COMMANDS[cmd](args)
    finally:
        D.shutdown()
    if rc:
        raise SystemExit(rc)


def _spawn_ranks(args, cmd, solvers):
    """Run command `cmd` in args.devices ranks (module notes) and wait for
    them. SIGINT and SIGHUP sent to this process go on to every rank
    (whose loop agrees on the iteration to act at). A rank's error raises
    here."""
    import signal

    import torch.multiprocessing as mp

    n = args.devices
    mesh = _devices_mesh(args)
    for solver in solvers:
        _precheck_batch(args, solver)
    threads = max(torch.get_num_threads() // n, 1) \
        if mesh.device(0).type == "cpu" else 0
    argd = {k: v for k, v in vars(args).items() if k != "fn"}
    ctx = mp.start_processes(_rank_main, args=(cmd, argd, _free_port(), n, threads),
                             nprocs=n, join=False, start_method="spawn")

    def forward(sig, frame):
        for proc in ctx.processes:
            if proc.is_alive():
                os.kill(proc.pid, sig)

    prev = {sig: signal.signal(sig, forward)
            for sig in (signal.SIGINT, signal.SIGHUP)}
    try:
        while not ctx.join(timeout=1.0):
            pass
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    return 0


def cmd_train(args):
    from mscnn_torch.train import loop as LP

    if args.devices > 1 and _rank(args) is None:
        return _spawn_ranks(args, "train", [args.solver])
    state, step, make_batch_source, lspec, _, _ = \
        _build_training(args, args.solver)
    if args.iterations:
        lspec = dataclasses.replace(lspec, max_iter=args.iterations)
    with make_batch_source() as src:
        LP.solve(step, state, src.get, lspec, seed=args.seed, rank=_rank(args))
    if not _rank(args):
        print("Optimization Done.")
    return 0


def cmd_train2(args):
    """Two-step schedule (train_mscnn.sh): stage 1, then stage 2
    warm-started from stage 1's final snapshot."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.io import checkpoint as CKPT

    if args.devices > 1 and _rank(args) is None:
        return _spawn_ranks(args, "train2", [args.solver1, args.solver2])
    a1 = argparse.Namespace(**vars(args))
    a1.solver = args.solver1
    a1.snapshot = None
    rc = cmd_train(a1)
    if rc:
        return rc

    fields = PB.parse_prototxt_file(args.solver1)
    prefix = args.snapshot_prefix or str(fields.get("snapshot_prefix", "mscnn"))
    stage1_ckpt = CKPT.latest_snapshot(prefix)
    if stage1_ckpt is None:
        raise SystemExit("stage-1 snapshot not found")

    a2 = argparse.Namespace(**vars(args))
    a2.solver = args.solver2
    a2.weights = stage1_ckpt
    a2.snapshot = None
    return cmd_train(a2)


def _no_devices(args, command):
    """`command` takes --devices as the JAX CLI's does (mscnn_tpu/cli.py
    `_add_common`), which ignores it there; the port refuses what JAX
    silently ignores."""
    n = int(getattr(args, "devices", 1) or 1)
    if n > 1:
        raise SystemExit(f"{command} --devices {n}: the JAX CLI's {command} "
                         "takes --devices and ignores it; the port refuses it "
                         "rather than ignore it (drop --devices)")


def _seed_params(cfg, ccfg, dev):
    """Seed-0 params of the model (the cascade's with ccfg), on dev."""
    from mscnn_torch.models import cascade as CC
    from mscnn_torch.models import mscnn as M

    gen = torch.Generator().manual_seed(0)
    if ccfg is not None:
        return CC.init_params(gen, ccfg, device=dev)
    return M.init_params(gen, cfg, device=dev)


def _deploy_model(args, dev, default_zoo):
    """(cfg, ccfg or None, params) of --model / --zoo in deploy geometry,
    with --bf16 and --conv1 applied and --weights restored."""
    from mscnn_torch.config import zoo_import as Z
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import zoo
    from mscnn_torch.models.cascade import CascadeConfig

    if args.model:
        cfg = Z.deploy_model_from_prototxt(args.model)
    else:
        cfg = zoo.get(args.zoo or default_zoo, deploy=True)
    ccfg = cfg if isinstance(cfg, CascadeConfig) else None
    if ccfg is not None:
        cfg = ccfg.base
    if args.bf16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg = _apply_conv1(cfg, args, dev)
    if ccfg is not None:
        ccfg = dataclasses.replace(ccfg, base=cfg)
    params = _seed_params(cfg, ccfg, dev)
    if args.weights:
        params = CKPT.restore_params(args.weights, params)
    return cfg, ccfg, params


def _cast_once(params, cfg):
    """At bf16 the float weights cast once, after any int8 calibration
    (which quantizes the float32 weights, as JAX does): the same values
    the forward would cast to on every call."""
    from mscnn_torch.models import mscnn as M

    if cfg.compute_dtype != "bfloat16":
        return params
    return M.cast_params(params, torch.bfloat16)


def cmd_test(args):
    """Forward-only metric evaluation over --iterations batches (the
    prototxt's TEST-phase data / sampling parameters by default)."""
    from mscnn_torch.train import loop as LP
    from mscnn_torch.train import train_step as T

    if args.devices > 1 and _rank(args) is None:
        return _spawn_ranks(args, "test", [args.solver])
    state, _, make_batch_source, lspec, cfg, tspec = \
        _build_training(args, args.solver)
    dev = _device(args)
    mesh = _devices_mesh(args)
    if cfg is None:     # generic prototxt: the tspec slot holds the Net
        from mscnn_torch.train import generic as G
        eval_step = G.make_eval_step(tspec, mesh=mesh)
    else:
        eval_step = T.make_eval_step(cfg, tspec, mesh=mesh)
    n = args.iterations or lspec.test_iter or 50
    sub = () if _rank(args) is None else (_rank(args),)
    with make_batch_source() as src:
        out = LP.test_eval(
            eval_step, state["params"], (src.get() for _ in range(n)),
            lambda i: LP.iteration_generator(args.seed, i, dev, *sub),
            log=None if not _rank(args) else LP._silent)
    if not _rank(args):
        print(json.dumps({k: round(v, 6) for k, v in out.items()}))
    return 0


_COMMANDS = {"train": cmd_train, "train2": cmd_train2, "test": cmd_test}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timer(dev, iters: int):
    """ms a call of fn(*a): after one warm-up call, `iters` calls between
    two CUDA events on a card, on the host clock elsewhere."""
    def timed(fn, *fargs):
        fn(*fargs)
        if torch.device(dev).type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            start.record()
            for _ in range(iters):
                fn(*fargs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = _time.perf_counter()
        for _ in range(iters):
            fn(*fargs)
        return (_time.perf_counter() - t0) / iters * 1e3
    return timed


def _time_layers(args):
    """Per-layer forward and forward + backward times of a prototxt net,
    the `caffe time` table (tools/caffe.cpp:369-419). Each layer runs alone
    on the materialised blobs of one forward pass, so the column sums
    exceed the whole net's time. A layer with no float output to
    differentiate, or whose backward raises, reads nan."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.models.netbuilder import Net
    from mscnn_torch.train import generic as G

    _sourced = ("ImageData", "HDF5Data", "DummyData", "WindowData")
    dev = _device(args)
    net = Net(args.model, phase="TRAIN")
    data_layer = G.find_data_layer(net)
    inputs = {}
    if data_layer is not None:
        ltype = str(data_layer.get("type"))
        if ltype not in _sourced:
            print(f"time --layers cannot source a {ltype!r} layer (the "
                  "JAX CLI's time sources ImageData, HDF5Data, DummyData "
                  "and WindowData only)")
            return 1
        # one batch of the net's own data layer gives the top shapes and
        # values, as caffe time runs the data layer (and generic.setup)
        first = G.make_batch_source(net, data_layer, train=True)()
        net = Net(args.model, phase="TRAIN",
                  input_shapes={k: tuple(v.shape) for k, v in first.items()})
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in first.items()}
    for n, sh in net.inputs().items():      # Input-layer blobs: zeros
        inputs.setdefault(n, torch.zeros(sh, device=dev))
    params = net.init(torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        blobs = net.apply(params, inputs)
    timed = _timer(dev, args.iterations or 10)

    print(f"{'layer':<24}{'type':<20}{'fwd ms':>10}{'bwd ms':>10}")
    tot_f = tot_b = 0.0
    for layer in net.layers:
        ltype = str(layer.get("type"))
        if ltype in ("Input", "Silence") or ltype in G.DATA_LAYER_TYPES:
            continue
        name = str(layer.get("name"))
        bots = [blobs[str(b)] for b in PB.as_list(layer.get("bottom"))]

        def run(lp, bb, layer=layer, name=name):
            p2 = {**params, name: lp} if name in params else params
            return net.apply_layer(layer, p2, bb)[0]

        def fwd_bwd(lp, bb, run=run):
            lp = {k: v.detach().requires_grad_() for k, v in lp.items()
                  if v.is_floating_point()}
            bb = [b.detach().requires_grad_() if b.is_floating_point() else b
                  for b in bb]
            outs = [o for o in run(lp, bb)
                    if torch.is_tensor(o) and o.is_floating_point()]
            wrt = list(lp.values()) + [b for b in bb if b.requires_grad]
            torch.autograd.grad(sum(o.sum() for o in outs), wrt,
                                allow_unused=True)

        lp = params.get(name, {})
        with torch.no_grad():
            fwd_ms = timed(run, lp, bots)
        try:
            bwd_ms = timed(fwd_bwd, lp, bots)
        except (RuntimeError, TypeError, AttributeError):
            bwd_ms = float("nan")   # not differentiable (ArgMax, ...)
        tot_f += fwd_ms
        tot_b += 0.0 if bwd_ms != bwd_ms else bwd_ms
        print(f"{name:<24}{ltype:<20}{fwd_ms:>10.3f}{bwd_ms:>10.3f}")
    print(f"{'TOTAL (unfused sum)':<44}{tot_f:>10.3f}{tot_b:>10.3f}")
    return 0


def cmd_time(args):
    """Per-stage wall times (the `caffe time` analog): forward, and
    forward + backward + update; --stages adds a per-stage table with
    FLOPs (utils/profiling.py::cost_flops) and MFU."""
    from mscnn_torch import inference as I
    from mscnn_torch.config import zoo_import as Z
    from mscnn_torch.data.synthetic import make_batch
    from mscnn_torch.models import cascade as CC
    from mscnn_torch.models import mscnn as M
    from mscnn_torch.models import zoo
    from mscnn_torch.train import solver as S
    from mscnn_torch.train import train_step as T
    from mscnn_torch.utils import profiling as PROF

    if getattr(args, "layers", False):
        if not args.model:
            print("--layers needs --model <prototxt> (per-layer timing runs "
                  "on the generic net builder)")
            return 1
        return _time_layers(args)
    if args.int8_heads and not args.int8:
        print("--int8-heads extends the int8 trunk; pass --int8 too")
        return 1
    _no_devices(args, "time")
    dev = _device(args)
    ccfg = None
    if args.model:
        cfg, tspec, _, _, _ = Z.model_from_prototxt(args.model)
    else:
        kwargs = {"deploy": True} if args.deploy else {}
        cfg = zoo.get(args.zoo or "kitti_car/mscnn-7s-576-2x", **kwargs)
        tspec = T.TrainSpec()
    if isinstance(cfg, CC.CascadeConfig):
        ccfg, cfg = cfg, cfg.base
    if args.input_hw:
        cfg = dataclasses.replace(cfg, input_hw=tuple(args.input_hw))
    if args.max_out:
        # post-NMS roi capacity: every ROI-stage cost is linear in it
        cfg = dataclasses.replace(cfg, proposal=dataclasses.replace(
            cfg.proposal, max_out=int(args.max_out)))
    if args.bf16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg = _apply_conv1(cfg, args, dev)
    if ccfg is not None:
        ccfg = dataclasses.replace(ccfg, base=cfg)
    b = args.batch_size or 4
    h, w = cfg.input_hw

    sspec = S.SolverSpec()
    params = _seed_params(cfg, ccfg, dev)
    if args.int8:
        # timing-only PTQ: scales calibrated from synthetic images (the
        # numerics are covered by the synthetic e2e examples; the timing
        # is the same for any scale values); the train step keeps the
        # compute dtype (PTQ is deploy-only)
        from mscnn_torch.ops import quant as Q
        cal = np.random.RandomState(0).rand(2, h, w, 3).astype(np.float32) \
            * 150.0 - 75.0
        scales = Q.calibrate_trunk_scales(
            params, cfg, cal, include_conv1=not (cfg.pallas_conv1 or cfg.s2d_conv1))
        params = Q.quantize_trunk(params, scales)
        cfg = dataclasses.replace(cfg, int8_trunk=True)
        if args.int8_heads:
            params, cfg = _int8_quantize_heads(params, cfg, cal, ccfg=ccfg)
        if ccfg is not None:
            ccfg = dataclasses.replace(ccfg, base=cfg)
    if ccfg is not None:
        fwd = I.make_cascade_forward(params, ccfg)
        step = T.make_train_step(
            cfg, tspec, sspec, loss_function=functools.partial(
                _cascade_objective, ccfg=ccfg, roi_batch=tspec.roi_batch))
    else:
        fwd = I.make_forward(params, cfg)
        step = T.make_train_step(cfg, tspec, sspec)

    batch = make_batch(cfg, batch=b, device=dev)
    images = batch["image"]
    state = {"params": params, "solver": S.init_state(params, sspec)}

    def bench(fn, *fargs, iters=args.iterations or 10):
        fn(*fargs)          # warm-up (kernel builds, caches)
        _sync(dev)
        t0 = _time.perf_counter()
        for _ in range(iters):
            fn(*fargs)
        _sync(dev)
        return (_time.perf_counter() - t0) / iters * 1e3

    fwd_ms = bench(fwd, params, images)
    print(f"Average Forward pass: {fwd_ms:.2f} ms ({b} images)")
    if args.int8:
        print(f"Throughput: {b / (fwd_ms / 1e3):.2f} infer img/s "
              "(int8: train timing skipped)")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        step_ms = bench(lambda st: step(st, batch, generator=gen), state)
        print(f"Average Forward-Backward-Update: {step_ms:.2f} ms")
        print(f"Throughput: {b / (step_ms / 1e3):.2f} train img/s, "
              f"{b / (fwd_ms / 1e3):.2f} infer img/s")

    if args.stages:
        def trunk(p, x):
            with torch.inference_mode():
                return M.trunk(p, x, cfg)

        stages = {"full_deploy": fwd} if ccfg is not None else \
            {"trunk": trunk, "full_deploy": fwd}
        peak = PROF.peak_flops(dev)
        print(f"{'stage':<14}{'ms/img':>10}{'GFLOP':>10}{'MFU':>8}")
        rows = {}
        for name, fn in stages.items():
            fl = PROF.cost_flops(fn, params, images)
            fl = fl / b if fl else None
            ms = bench(fn, params, images, iters=30) / b
            rows[name] = (ms, fl)
            util = (fl / (ms / 1e3) / peak) if (fl and peak) else None
            print(f"{name:<14}{ms:>10.2f}{(fl or 0) / 1e9:>10.1f}"
                  f"{('%.1f%%' % (100 * util)) if util else '   n/a':>8}")
        (t_ms, t_fl), (f_ms, f_fl) = rows.get("trunk", (None, None)), \
            rows["full_deploy"]
        if f_fl and t_fl:
            ms, fl = f_ms - t_ms, f_fl - t_fl
            util = fl / (ms / 1e3) / peak if (ms > 0 and peak) else None
            print(f"{'heads+nms+roi':<14}{ms:>10.2f}{fl / 1e9:>10.1f}"
                  f"{('%.1f%%' % (100 * util)) if util else '   n/a':>8}")
    return 0


def _read_image(path):
    """The decoded image, or None where the file does not decode (as
    cv2.imread returns None); a BMP, TIFF or WEBP file, or a JPEG mode
    data/jpeg.py does not decode, raises."""
    from mscnn_torch.data import image_io

    try:
        return image_io.imread(path)
    except (FileNotFoundError, ValueError):
        return None


def _image_paths(image_dir, recursive=False):
    import glob

    if recursive:
        return sorted(glob.glob(os.path.join(image_dir, "**", "*.png"), recursive=True)
                      + glob.glob(os.path.join(image_dir, "**", "*.jpg"), recursive=True))
    return sorted(glob.glob(os.path.join(image_dir, "*.png"))
                  + glob.glob(os.path.join(image_dir, "*.jpg")))


def _int8_quantize(params, cfg, image_dir, ncal, *, ccfg=None, heads=False):
    """PTQ int8 trunk calibration from the first images of a directory.
    Returns (params, cfg) or None when no image is readable. With
    heads=True, also calibrates and quantizes the ROI-head matmuls
    (roi_c1 / fc6 with the cascade suffixes) on the int8 trunk."""
    from mscnn_torch.data.resize import resize_bilinear_u8
    from mscnn_torch.ops import quant as Q

    net_h, net_w = cfg.input_hw
    mean = np.asarray([104.0, 117.0, 123.0], np.float32)
    cals = []
    for p in _image_paths(image_dir)[:ncal]:
        im = _read_image(p)
        if im is None:
            continue
        cals.append(resize_bilinear_u8(im, (net_w, net_h)).astype(np.float32) - mean)
    if not cals:
        return None
    scales = Q.calibrate_trunk_scales(
        params, cfg, np.stack(cals),
        include_conv1=not (cfg.pallas_conv1 or cfg.s2d_conv1))
    params = Q.quantize_trunk(params, scales)
    cfg = dataclasses.replace(cfg, int8_trunk=True)
    print(f"int8 trunk: calibrated {len(scales)} layers from {len(cals)} images")
    if heads:
        params, cfg = _int8_quantize_heads(params, cfg, np.stack(cals), ccfg=ccfg)
    return params, cfg


def _int8_quantize_heads(params, cfg, cal_images, *, ccfg=None):
    """ROI-head PTQ on top of an (already quantized) trunk: run the deploy
    graph capturing the roi_c1 / fc6 input maxima, quantize those matmuls,
    and set int8_roi_head."""
    from mscnn_torch.ops import quant as Q

    hccfg = dataclasses.replace(ccfg, base=cfg) if ccfg is not None else None
    hscales = Q.calibrate_roi_head_scales(params, cfg, cal_images, ccfg=hccfg)
    params = Q.quantize_roi_heads(params, hscales)
    cfg = dataclasses.replace(cfg, int8_roi_head=True)
    print(f"int8 ROI heads: calibrated {len(hscales)} matmuls")
    return params, cfg


def cmd_detect(args):
    """Batch detection over an image directory -> KITTI label files (the
    run_mscnn_detection.m + writeDetForEval.m pipeline), or the caltech /
    widerface layouts."""
    import collections
    import concurrent.futures as _cf
    import itertools

    from mscnn_torch import inference as I

    if args.int8_heads and not args.int8 and not args.compiled:
        print("--int8-heads extends the int8 trunk; pass --int8 too")
        return 1
    if args.compiled and int(args.devices or 1) > 1:
        print("--compiled artifacts are single-program exports; drop --devices")
        return 1
    mesh = _devices_mesh(args)
    dev = _device(args) if mesh is None else mesh.device(0)
    compiled = None
    if args.compiled:
        # the artifact holds program + weights + DetectSpec; the model,
        # weights and precision flags were fixed when it was compiled
        from mscnn_torch.io import aot
        compiled = aot.load_deploy(args.compiled, device=dev)
        num_classes = int(compiled.meta["num_classes"])
        ignored = [f for f, on in (
            ("--model", args.model), ("--zoo", args.zoo),
            ("--weights", args.weights), ("--bf16", args.bf16),
            ("--int8", args.int8), ("--int8-heads", args.int8_heads),
            ("--conv1", args.conv1 != "auto"),
            ("--score-thr", bool(args.score_thr))) if on]
        if ignored:
            print(f"note: {', '.join(ignored)} ignored -- the artifact fixes "
                  "model/weights/precision/DetectSpec at compile time; "
                  "recompile with `compile` to change them")
    else:
        cfg, ccfg, params = _deploy_model(args, dev, "kitti_car/mscnn-7s-576-2x")
        num_classes = cfg.num_classes
        if args.int8:
            quantized = _int8_quantize(
                params, cfg, args.image_dir, max(int(args.calib_images or 4), 1),
                ccfg=ccfg, heads=args.int8_heads)
            if quantized is None:
                print("no readable calibration images")
                return 1
            params, cfg = quantized
            if ccfg is not None:
                ccfg = dataclasses.replace(ccfg, base=cfg)
        params = _cast_once(params, cfg)

    names = args.class_names.split(",") if args.class_names else \
        I.KITTI_CLASS_NAMES["kitti_car"][:num_classes]
    spec = I.DetectSpec(score_thr=args.score_thr)
    group_size = 1
    if compiled is not None:
        if compiled.batch > 1:
            # throughput artifact: grouped, padded batch calls
            group_size = compiled.batch
            run_detect_batch = compiled.detect_many
        else:
            run_detect = compiled.detect
    elif mesh is not None:
        # data-parallel serving: one call over the mesh a group of N images
        # (the tail padded with its last image, the extras dropped)
        fwd = I.make_cascade_forward(params, ccfg, mesh=mesh) \
            if ccfg is not None else I.make_forward(params, cfg, mesh=mesh)
        group_size = mesh.size

        def run_detect_batch(imgs):
            imgs = imgs + [imgs[-1]] * (group_size - len(imgs))
            return I.detect_batch(params, imgs, cfg, spec, fwd=fwd,
                                  cascade=ccfg)
    elif ccfg is not None:
        def run_detect(img):
            return I.detect_cascade(params, img, ccfg, spec)
    else:
        # the single-call serving graph: uint8 transfer, decode on device
        fwd = I.make_e2e_forward(params, cfg, spec)

        def run_detect(img):
            return I.detect(params, img, cfg, spec, e2e_fwd=fwd)

    fmt = args.format
    # the widerface layout nests images under event dirs
    paths = _image_paths(args.image_dir, recursive=fmt == "widerface")
    if args.iterations:
        paths = paths[:args.iterations]
    buffered = {}   # i -> (path, det) for the whole-set writers below

    # decode on worker threads so host IO overlaps device compute
    depth = max(int(args.loader_threads or 2), 1)
    pool = _cf.ThreadPoolExecutor(max_workers=depth)
    path_iter = iter(paths)
    pending = collections.deque((p, pool.submit(_read_image, p))
                                for p in itertools.islice(path_iter, depth + 2))
    done = {"n": 0, "t_first": None}

    def write_one(i, path, det):
        done["n"] += 1
        if done["n"] == 1:
            done["t_first"] = _time.perf_counter()   # the first call builds
        if fmt != "kitti":
            buffered[i] = (path, det)
        else:
            stem = os.path.splitext(os.path.basename(path))[0]
            try:
                img_idx = int(stem)
            except ValueError:
                img_idx = i
            I.write_kitti_labels(I.detections_to_kitti(det, names),
                                 args.output_dir, img_idx)
        if (i + 1) % 100 == 0:
            avg = (_time.perf_counter() - t0) / (i + 1)
            print(f"idx {i + 1}/{len(paths)}, avgtime={avg:.4f}s")

    t0 = _time.perf_counter()
    i = -1
    group = []   # (i, path, img) for the batched artifact

    def flush_group():
        dets = run_detect_batch([g[2] for g in group])
        for (gi, gpath, _), det in zip(group, dets):
            write_one(gi, gpath, det)
        group.clear()

    try:
        while pending:
            i += 1
            path, fut = pending.popleft()
            img = fut.result()
            nxt = next(path_iter, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(_read_image, nxt)))
            if img is None:
                print(f"skipping unreadable image {path}")
                continue
            if group_size > 1:
                group.append((i, path, img))
                if len(group) == group_size:
                    flush_group()
            else:
                write_one(i, path, run_detect(img))
        if group:   # the tail (detect_many pads it)
            flush_group()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    comp_id = args.comp_id or "mscnn"
    if fmt == "caltech":
        # one flat imgIdx,x,y,w,h,score file a class
        # (run_mscnn_detection.m:159-167; images keep the paths' order)
        from mscnn_torch.evaluation import caltech_eval as CE
        os.makedirs(args.output_dir, exist_ok=True)
        for k, name in enumerate(names):
            if k == 0:
                continue  # background
            per_img = [I.detections_to_xywh(buffered[j][1], cls_id=k)
                       if j in buffered else np.zeros((0, 5))
                       for j in range(len(paths))]
            CE.write_detections(os.path.join(args.output_dir,
                                             f"{comp_id}_{name}.txt"), per_img)
    elif fmt == "widerface":
        # per-event dirs of per-image txts (run_mscnn_detection.m:173-199);
        # the event is the image's directory relative to --image-dir
        from mscnn_torch.evaluation import widerface_eval as WE
        events = {}
        for j in range(len(paths)):
            if j not in buffered:
                continue
            path, det = buffered[j]
            rel = os.path.relpath(os.path.dirname(path), args.image_dir)
            event = "event0" if rel == "." else rel
            stem = os.path.splitext(os.path.basename(path))[0]
            events.setdefault(event, {})[stem] = I.detections_to_xywh(det, cls_id=1)
        WE.write_detections(args.output_dir, comp_id, events)

    n = max(len(paths), 1)
    end = _time.perf_counter()
    msg = f"Done: {len(paths)} images, {(end - t0) / n:.4f} s/img"
    if done["n"] > 1 and done["t_first"] is not None:
        steady = (end - done["t_first"]) / (done["n"] - 1)
        msg += f" ({steady:.4f} s/img steady-state; the first call builds)"
    print(msg + f", labels in {args.output_dir}")
    return 0


def cmd_parity(args):
    """One-shot AP-parity harness against the pretrained reference model:
    .caffemodel import -> detect over the KITTI val split -> official
    KITTI AP -> a +-tolerance verdict against the expected AP (the
    run_mscnn_detection.m:24-162 flow, then evaluate_object.cpp)."""
    import glob
    import tempfile

    from mscnn_torch.evaluation import kitti_eval as KE

    root = args.kitti_root
    img_dir = next((d for d in (os.path.join(root, "training", "image_2"),
                                os.path.join(root, "image_2"),
                                os.path.join(root, "images"), root)
                    if glob.glob(os.path.join(d, "*.png"))
                    or glob.glob(os.path.join(d, "*.jpg"))), None)
    gt_dir = next((d for d in (os.path.join(root, "training", "label_2"),
                               os.path.join(root, "label_2"),
                               os.path.join(root, "labels"), root)
                   if glob.glob(os.path.join(d, "*.txt"))), None)
    if img_dir is None or gt_dir is None:
        print(f"no images/labels under {root!r} (expected KITTI devkit "
              f"layout: training/image_2 + training/label_2)")
        return 1
    if args.image_set:
        ids = [int(l) for l in open(args.image_set).read().split()]
        subset = tempfile.mkdtemp(prefix="mscnn_parity_")
        for i in ids:
            for ext in (".png", ".jpg"):
                src = os.path.join(img_dir, f"{i:06d}{ext}")
                if os.path.exists(src):
                    os.symlink(src, os.path.join(subset, f"{i:06d}{ext}"))
        img_dir = subset

    out_dir = args.output_dir or tempfile.mkdtemp(prefix="mscnn_parity_out_")
    det = argparse.Namespace(
        model=args.model, zoo=args.zoo, weights=args.weights, bf16=args.bf16,
        conv1=args.conv1, image_dir=img_dir, output_dir=out_dir,
        class_names=args.class_names, score_thr=0.0, loader_threads=2,
        iterations=args.iterations, devices=args.devices, device=args.device,
        int8=False, int8_heads=False, calib_images=4, compiled=None,
        format="kitti", comp_id="mscnn")
    rc = cmd_detect(det)
    if rc:
        return rc

    ids = sorted(int(os.path.splitext(os.path.basename(p))[0])
                 for p in glob.glob(os.path.join(out_dir, "*.txt"))
                 if os.path.exists(os.path.join(gt_dir, os.path.basename(p))))
    if not ids:
        print("no detection/gt id overlap to score")
        return 1
    classes = (args.class_names or "bg,car").lower().split(",")
    classes = [c for c in classes if c != "bg"][:1] if args.cls is None \
        else [args.cls.lower()]
    table = KE.evaluate(gt_dir, out_dir, ids, classes=classes)
    cls = classes[0]
    ap = table[cls]["moderate"]
    delta = ap - args.expected_ap
    verdict = "PASS" if delta >= -args.tolerance else "FAIL"
    print(json.dumps({
        "class": cls,
        "ap": {k: round(v, 2) for k, v in table[cls].items()},
        "moderate_ap": round(ap, 2),
        "expected_ap": args.expected_ap,
        "delta": round(delta, 2),
        "tolerance": args.tolerance,
        "images": len(ids),
        "verdict": verdict,
    }))
    print(f"KITTI {cls} moderate AP {ap:.2f} vs reference "
          f"{args.expected_ap:.2f} ({delta:+.2f} pt, tol "
          f"+-{args.tolerance}) -> {verdict}")
    return 0 if verdict == "PASS" else 2


def cmd_eval(args):
    """Detection scoring: KITTI AP (default), caltech MR-2 or widerface AP,
    the three protocols of the reference's zoo (KITTI's
    evaluate_object.cpp; the caltech and widerface toolboxes,
    reimplemented)."""
    dataset = args.dataset
    required = {"kitti": ("gt_dir", "result_dir"),
                "caltech": ("gt_dir", "result_file"),
                "widerface": ("result_dir",)}[dataset]
    missing = [f"--{r.replace('_', '-')}" for r in required
               if not getattr(args, r, None)]
    if dataset == "widerface" and not (args.gt_file or args.gt_mat):
        missing.append("--gt-file or --gt-mat")
    if missing:
        raise SystemExit(f"eval --dataset {dataset} requires {' '.join(missing)}")
    if dataset == "caltech":
        from mscnn_torch.evaluation import caltech_eval as CE

        setting = CE.REASONABLE if args.setting == "reasonable" else CE.ALL
        out = CE.evaluate_dirs(args.gt_dir, args.result_file, setting=setting)
        print(json.dumps({"mr2": round(out["mr2"], 4),
                          "n_images": out["n_images"],
                          "n_pos": out["n_pos"]}))
        return 0
    if dataset == "widerface":
        from mscnn_torch.evaluation import widerface_eval as WE

        keep = None
        if args.gt_mat:
            # the official devkit split (+ the curated difficulty keep lists)
            gts, keep = WE.load_split_mat(args.gt_mat, args.difficulty_mat)
        else:
            gts = WE.parse_gt(args.gt_file)
        out = WE.evaluate(WE.read_detections(args.result_dir), gts, keep=keep)
        print(json.dumps({"ap": round(out["ap"], 4), "n_gt": out["n_gt"]}))
        return 0

    import glob

    from mscnn_torch.evaluation import kitti_eval as KE

    if args.image_set:
        ids = [int(l) for l in open(args.image_set).read().split()]
    else:
        ids = sorted(int(os.path.splitext(os.path.basename(p))[0])
                     for p in glob.glob(os.path.join(args.gt_dir, "*.txt")))
    classes = (args.class_names or "car").split(",")
    out = KE.evaluate(args.gt_dir, args.result_dir, ids, classes=classes,
                      stats_dir=args.stats_dir)
    print(json.dumps({c: {k: round(v, 2) for k, v in d.items()}
                      for c, d in out.items()}))
    return 0


def cmd_export(args):
    """Export params to the reference's .caffemodel wire format
    (NetParameter binaryproto, net.cpp:856-866)."""
    from mscnn_torch.config import zoo_import as Z
    from mscnn_torch.io import caffemodel as CM
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import zoo
    from mscnn_torch.models.cascade import CascadeConfig

    dev = _device(args)
    if args.model:
        # a deploy prototxt if it has Input dims, else a trainval net
        try:
            cfg = Z.deploy_model_from_prototxt(args.model)
        except ValueError:
            if Z.is_cascade_prototxt(args.model):
                cfg = Z.cascade_from_prototxt(args.model)[0]
            else:
                cfg = Z.model_from_prototxt(args.model)[0]
    else:
        cfg = zoo.get(args.zoo or "kitti_car/mscnn-8s-768-trainval", deploy=True)
    ccfg = cfg if isinstance(cfg, CascadeConfig) else None
    params = _seed_params(cfg if ccfg is None else ccfg.base, ccfg, dev)
    if args.weights:
        params = CKPT.restore_params(args.weights, params)
    # the layers in name order, as the JAX CLI writes them (its
    # `jax.device_get` rebuilds the params dict with sorted keys)
    n = CM.save_caffemodel(dict(sorted(params.items())), args.output)
    print(f"Wrote {n} layers to {args.output}")
    return 0


def cmd_compile(args):
    """Compile the deploy serving graph to an artifact directory
    (`io/aot.py`): a `torch.export` program + weights + metadata, the
    analog of shipping mscnn_deploy.prototxt + .caffemodel to a serving
    host (run_mscnn_detection.m:24-27), except that the host needs no model
    code."""
    from mscnn_torch import inference as I
    from mscnn_torch.io import aot

    if args.int8_heads and not args.int8:
        print("--int8-heads extends the int8 trunk; pass --int8 too")
        return 1
    _no_devices(args, "compile")
    platforms = args.platforms.split(",") if args.platforms else None
    if platforms and args.device is None:
        # the program is traced on the device type it names
        args.device = platforms[0]
    elif platforms and torch.device(args.device).type != platforms[0]:
        raise SystemExit(f"--platforms {args.platforms} and --device "
                         f"{args.device} disagree")
    dev = _device(args)
    cfg, ccfg, params = _deploy_model(args, dev, "kitti_car/mscnn-8s-768-trainval")
    if args.int8:
        if not args.calib_dir:
            print("--int8 needs --calib-dir (images for PTQ calibration)")
            return 1
        quantized = _int8_quantize(params, cfg, args.calib_dir,
                                   max(int(args.calib_images or 4), 1),
                                   ccfg=ccfg, heads=args.int8_heads)
        if quantized is None:
            print("no readable calibration images in --calib-dir")
            return 1
        params, cfg = quantized
        if ccfg is not None:
            ccfg = dataclasses.replace(ccfg, base=cfg)
    spec = I.DetectSpec(score_thr=args.score_thr)
    aot.export_deploy(_cast_once(params, cfg), cfg, args.output, spec=spec,
                      platforms=platforms,
                      batch=max(int(args.batch or 1), 1), cascade=ccfg)
    with open(os.path.join(args.output, "meta.json")) as f:
        meta = json.load(f)
    print(f"Wrote AOT artifact to {args.output} (platforms={meta['platforms']}, "
          f"{meta['param_leaves']} param leaves, kernel ops {meta['kernel_ops']}); "
          f"serve with `python -m mscnn_torch.cli detect --compiled "
          f"{args.output} ...`")
    return 0


def cmd_serve(args):
    """HTTP serving endpoint over an artifact (`serve.py`): GET /healthz,
    POST /detect with image bytes -> JSON detections."""
    from mscnn_torch import serve as SV

    names = args.class_names.split(",") if args.class_names else None
    return SV.serve(args.compiled, args.port, class_names=names,
                    device=_device(args))


def cmd_device_query(args):
    """The CUDA devices, one line each, as the JAX CLI lists its devices;
    with none, the CPU the port would then need `--device cpu` for."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"Device {i}: {p.name} (cuda), process 0, capability "
              f"{p.major}.{p.minor}, {p.total_memory / 2 ** 30:.1f} GiB")
    if not n:
        print("Device 0: cpu (cpu), process 0 (no CUDA device: the commands "
              "need --device cpu here)")
    return 0


def cmd_convert_imageset(args):
    """Pack a window file / image list into a record shard, an LMDB or a
    LevelDB, or migrate a Caffe database to a record shard (the
    tools/convert_imageset.cpp analog; see tools.py)."""
    from mscnn_torch import tools as TL

    n = TL.convert_imageset(
        args.output, window_file=args.window_file, listfile=args.listfile,
        from_lmdb=args.from_lmdb, from_leveldb=args.from_leveldb,
        root_folder=args.root_folder,
        shuffle=args.shuffle, seed=args.seed,
        encode=args.encode, quality=args.quality, backend=args.backend)
    print(f"Packed {n} records into {args.output}")
    return 0


def cmd_compute_mean(args):
    """Dataset mean (tools/compute_image_mean.cpp analog): prints the BGR
    mean_value triple; optionally writes a BlobProto binaryproto."""
    from mscnn_torch import tools as TL

    bgr, pixel = TL.compute_image_mean(args.source,
                                       root_folder=args.root_folder,
                                       output=args.output)
    print(f"mean_value (BGR): {bgr[0]:.4f} {bgr[1]:.4f} {bgr[2]:.4f}")
    if args.output:
        kind = "per-pixel" if pixel is not None else "per-channel"
        print(f"Wrote {kind} mean BlobProto to {args.output}")
    return 0


def cmd_resize_images(args):
    """Batch-resize an image dir / list to a fixed geometry
    (tools/extra/resize_and_crop_images.py parity)."""
    import glob

    from mscnn_torch import tools as TL

    if os.path.isdir(args.source):
        paths = sorted(sum((glob.glob(os.path.join(args.source, pat))
                            for pat in ("*.png", "*.jpg", "*.jpeg")), []))
    else:
        with open(args.source) as f:
            paths = [line.split()[0] for line in f if line.strip()]
    n = TL.resize_and_crop_images(paths, args.output_dir,
                                  width=args.width, height=args.height,
                                  crop=not args.no_crop,
                                  workers=args.workers)
    print(f"Wrote {n}/{len(paths)} images to {args.output_dir}")
    return 0


def cmd_summary(args):
    """Layer table of a net prototxt: name, type, output shape, param
    count (tools/extra/summarize.py parity, plus shapes from the generic
    net builder's shape inference, with the weights built on --device)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.models.netbuilder import Net

    net = Net(args.net, phase=args.phase)
    dev = _device(args)
    shapes, counts = {}, {}
    try:
        params = net.init(torch.Generator().manual_seed(0), device=dev)
        shapes = net.shapes
        counts = {name: sum(int(v.numel()) for v in p.values())
                  for name, p in params.items()}
    except Exception as e:  # still print the topology for exotic nets
        print(f"(shape inference unavailable: {e})")
    total = 0
    print(f"{'layer':<24}{'type':<18}{'output shape':<22}{'params':>10}")
    for layer in net.layers:
        name = str(layer.get("name"))
        tops = [str(t) for t in PB.as_list(layer.get("top"))]
        shape = shapes.get(tops[0]) if tops else None
        n = counts.get(name, 0)
        total += n
        print(f"{name:<24}{str(layer.get('type')):<18}"
              f"{str(shape or ''):<22}{n:>10,}")
    print(f"{'TOTAL':<64}{total:>10,}")
    return 0


def cmd_plot_log(args):
    """Training curves from a Solve-loop log -> png
    (tools/extra/plot_training_log.py.example parity). Needs matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_log draws with the matplotlib module, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mscnn_torch.utils import parse_log as PL

    rows = PL.parse_log_file(args.log)
    if not rows:
        print("no iterations found in log")
        return 1
    keys = sorted({k for r in rows for k in r}
                  - {"iteration", "iters_per_sec"})
    wanted = args.keys.split(",") if args.keys else ["loss"]
    fig, ax = plt.subplots(figsize=(8, 5))
    for key in wanted:
        if key not in keys:
            print(f"(no values for {key!r}; available: {', '.join(keys)})")
            continue
        pts = [(r["iteration"], r[key]) for r in rows if key in r]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], label=key)
    ax.set_xlabel("iteration")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"Wrote {args.out} ({len(rows)} points)")
    return 0


def cmd_upgrade_proto(args):
    """Migrate a legacy V0/V1 net or solver prototxt to the modern schema
    (tools/upgrade_net_proto_text.cpp / upgrade_solver_proto_text.cpp)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.config import upgrade as UP

    msg = PB.parse_prototxt_file(args.input)
    out = UP.upgrade_solver(msg) if args.kind == "solver" \
        else UP.upgrade_net(msg)
    text = PB.emit_prototxt(out) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"Wrote upgraded {args.kind} prototxt to {args.output}")
    else:
        print(text, end="")
    return 0


def cmd_draw(args):
    """Net topology -> Graphviz DOT (python/caffe/draw.py equivalent;
    render with `dot -Tpng out.dot` wherever graphviz is installed)."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.utils import draw as DR

    net = PB.parse_prototxt_file(args.net)
    DR.draw_net_to_file(net, args.out, rankdir=args.rankdir,
                        phase=args.phase)
    print(f"Wrote {args.out} ({len(PB.layers(net))} layers)")
    return 0


def cmd_vbb2bbgt(args):
    """Convert Caltech .vbb video annotations to per-frame bbGt v3 txts at
    the sampling stride, so `eval --dataset caltech` can score against the
    original annotation release; the default stride / offset is the
    devkit's 1 Hz extraction (every 30th frame, the first at index 29,
    I00029.jpg)."""
    import glob

    from mscnn_torch.evaluation import caltech_eval as CE

    if os.path.isdir(args.vbb):
        vbbs = sorted(glob.glob(os.path.join(args.vbb, "**", "*.vbb"),
                                recursive=True))
    else:
        vbbs = [args.vbb]
    if not vbbs:
        print(f"no .vbb files under {args.vbb}")
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    n_files = 0
    for vp in vbbs:
        stem = os.path.splitext(os.path.basename(vp))[0]
        parent = os.path.basename(os.path.dirname(os.path.abspath(vp)))
        prefix = f"{parent}_{stem}" if parent.startswith("set") else stem
        frames = CE.load_vbb(vp)
        for f in range(args.offset, len(frames), args.stride):
            CE.write_bbgt(
                os.path.join(args.output_dir, f"{prefix}_I{f:05d}.txt"),
                frames[f])
            n_files += 1
    print(f"Wrote {n_files} bbGt files from {len(vbbs)} vbb(s) "
          f"to {args.output_dir}")
    return 0


def cmd_extract_features(args):
    """Dump named activations over an image dir to HDF5
    (tools/extract_features.cpp analog): the trunk and heads of --model /
    --zoo (a cascade's base) in float32, on --device (the card by
    default)."""
    from mscnn_torch import tools as TL
    from mscnn_torch.config import zoo_import as Z
    from mscnn_torch.io import checkpoint as CKPT
    from mscnn_torch.models import zoo

    _no_devices(args, "extract_features")
    dev = _device(args)
    if args.model:
        cfg = Z.deploy_model_from_prototxt(args.model)
    else:
        cfg = zoo.get(args.zoo or "kitti_car/mscnn-8s-768-trainval",
                      deploy=True)
    # feature extraction reads trunk and head blobs only; a cascade's
    # base config and params carry them
    cfg = getattr(cfg, "base", cfg)
    params = _seed_params(cfg, None, dev)
    if args.weights:
        params = CKPT.restore_params(args.weights, params)
    paths = _image_paths(args.image_dir)
    if args.iterations:
        paths = paths[: args.iterations]
    shapes = TL.extract_features(params, cfg, paths,
                                 args.blobs.split(","), args.output)
    for name, shape in shapes.items():
        print(f"{name}: {(len(paths),) + shape}")
    return 0


def _add_common(p):
    p.add_argument("--model", help="trainval prototxt (overrides solver's net:)")
    p.add_argument("--weights", help="snapshot to warm-start params from")
    p.add_argument("--snapshot", help="snapshot to resume full state from")
    p.add_argument("--snapshot-prefix", default=None)
    p.add_argument("--window-file", help="override the net's data source path")
    p.add_argument("--root-folder", default="", help="image path prefix")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel width: train / train2 / test run a "
                        "rank a device, detect splits each batch over the "
                        "devices (cuda:0 .. N-1, or N CPU ranks with "
                        "--device cpu)")
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--conv1", default="auto",
                   choices=["auto", "plain", "s2d", "pallas"],
                   help="conv1 strategy (auto: the fused conv1 kernel on a "
                        "card at bf16, else plain)")
    p.add_argument("--no-native", action="store_true",
                   help="read the training data on one thread (the "
                        "one-thread pipeline) instead of the worker "
                        "loader's processes")
    p.add_argument("--uint8-input", action="store_true",
                   help="ship raw uint8 image canvases and normalize on "
                        "the device (bit-identical; 4x less host->device "
                        "traffic)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zoo", help="built-in zoo config name")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")


def _int8_flags(p, what):
    p.add_argument("--int8", action="store_true",
                   help=f"post-training int8 trunk (ops/quant.py){what}")
    p.add_argument("--int8-heads", action="store_true",
                   help="also quantize the ROI-head matmuls (roi_c1 / fc6, "
                        "with the cascade stages'); requires --int8")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="mscnn_torch", description="MS-CNN on the card (PyTorch / CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model from a solver prototxt")
    p_train.add_argument("--solver", required=True)
    _add_common(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_train2 = sub.add_parser("train2", help="two-step MS-CNN schedule")
    p_train2.add_argument("--solver1", required=True)
    p_train2.add_argument("--solver2", required=True)
    _add_common(p_train2)
    p_train2.set_defaults(fn=cmd_train2)

    p_test = sub.add_parser("test", help="evaluate metrics on the TEST config")
    p_test.add_argument("--solver", required=True)
    p_test.add_argument("--phase", default="TEST",
                        help="NetState phase for data/sampling params")
    _add_common(p_test)
    p_test.set_defaults(fn=cmd_test)

    p_time = sub.add_parser("time", help="benchmark fwd / fwd-bwd times")
    _add_common(p_time)
    p_time.add_argument("--deploy", action="store_true",
                        help="build the zoo config in deploy geometry")
    p_time.add_argument("--input-hw", type=int, nargs=2, metavar=("H", "W"),
                        help="override the input size, e.g. 1024 1024")
    p_time.add_argument("--max-out", type=int,
                        help="post-NMS roi capacity (zoo default 512; "
                             "bench.py's flagship protocol uses 256)")
    _int8_flags(p_time, ", calibrated from synthetic images (deploy "
                        "forward only)")
    p_time.add_argument("--stages", action="store_true",
                        help="per-stage time, FLOPs and MFU table")
    p_time.add_argument("--layers", action="store_true",
                        help="per-layer fwd / fwd+bwd table of a --model "
                             "prototxt (caffe time; each layer runs alone, "
                             "so the column sums exceed the whole net)")
    p_time.set_defaults(fn=cmd_time)

    p_det = sub.add_parser("detect", help="run detection over an image dir")
    p_det.add_argument("--image-dir", required=True)
    p_det.add_argument("--output-dir", required=True)
    p_det.add_argument("--class-names",
                       help="comma list incl. bg, e.g. bg,Car,Van,Truck,Tram")
    p_det.add_argument("--score-thr", type=float, default=0.0)
    p_det.add_argument("--loader-threads", type=int, default=2,
                       help="image-decode prefetch threads (IO overlaps "
                            "device compute)")
    _int8_flags(p_det, ", calibrated from the first --calib-images")
    p_det.add_argument("--calib-images", type=int, default=4)
    p_det.add_argument("--compiled",
                       help="serve from an artifact directory (`compile`); "
                            "the model / weights flags are fixed in it")
    p_det.add_argument("--format", default="kitti",
                       choices=["kitti", "caltech", "widerface"],
                       help="output layout: per-image KITTI labels, the flat "
                            "caltech file, or per-event widerface txts")
    p_det.add_argument("--comp-id", default="mscnn",
                       help="caltech/widerface result file prefix")
    _add_common(p_det)
    p_det.set_defaults(fn=cmd_detect)

    p_eval = sub.add_parser(
        "eval", help="detection scoring: KITTI AP / caltech MR-2 / widerface AP")
    p_eval.add_argument("--dataset", default="kitti",
                        choices=["kitti", "caltech", "widerface"])
    p_eval.add_argument("--gt-dir", help="kitti: label dir; caltech: bbGt v3 dir")
    p_eval.add_argument("--result-dir", help="kitti: per-image txt dir; "
                                             "widerface: per-event detection tree")
    p_eval.add_argument("--image-set", help="file of image ids, one per line")
    p_eval.add_argument("--class-names", default="car")
    p_eval.add_argument("--stats-dir", default=None,
                        help="write devkit-layout stats_/plot files here")
    p_eval.add_argument("--result-file",
                        help="caltech: flat imgIdx,x,y,w,h,score file")
    p_eval.add_argument("--gt-file", help="widerface: wider_face_*_bbx_gt.txt")
    p_eval.add_argument("--gt-mat", help="widerface: official wider_face_val.mat "
                                         "(alternative to --gt-file)")
    p_eval.add_argument("--difficulty-mat",
                        help="widerface: wider_{easy,medium,hard}_val.mat "
                             "curated keep list (requires --gt-mat)")
    p_eval.add_argument("--setting", default="reasonable",
                        choices=["reasonable", "all"], help="caltech gt filter")
    p_eval.set_defaults(fn=cmd_eval)

    p_par = sub.add_parser(
        "parity", help="one-shot AP parity against the pretrained reference "
                       "(.caffemodel import -> detect -> KITTI AP -> verdict)")
    p_par.add_argument("--weights", required=True,
                       help=".caffemodel (reference) or snapshot dir")
    p_par.add_argument("--kitti-root", required=True,
                       help="KITTI devkit root (training/image_2 + "
                            "training/label_2)")
    p_par.add_argument("--model", help="deploy prototxt")
    p_par.add_argument("--zoo", default="kitti_car/mscnn-8s-768-trainval")
    p_par.add_argument("--image-set", help="file of val-split image ids")
    p_par.add_argument("--output-dir", help="keep detection txts here")
    p_par.add_argument("--class-names", help="comma list incl. bg (default bg,car)")
    p_par.add_argument("--cls", help="class to score (default: first non-bg class)")
    p_par.add_argument("--expected-ap", type=float, default=89.0,
                       help="reference moderate AP (BASELINE.md: ~89-90 for "
                            "the 576/768 KITTI car models)")
    p_par.add_argument("--tolerance", type=float, default=0.5)
    p_par.add_argument("--iterations", type=int, default=0,
                       help="cap the number of images (smoke runs)")
    p_par.add_argument("--bf16", action="store_true")
    p_par.add_argument("--devices", type=int, default=1)
    p_par.add_argument("--conv1", default="auto",
                       choices=["auto", "plain", "s2d", "pallas"])
    _add_device(p_par)
    p_par.set_defaults(fn=cmd_parity)

    p_exp = sub.add_parser("export", help="export weights to .caffemodel")
    _add_common(p_exp)
    p_exp.add_argument("-o", "--output", required=True,
                       help="output .caffemodel path")
    p_exp.set_defaults(fn=cmd_export)

    p_cmp = sub.add_parser(
        "compile", help="compile the deploy graph to a serving artifact "
                        "(torch.export program + weights)")
    _add_common(p_cmp)
    p_cmp.add_argument("-o", "--output", required=True,
                       help="artifact output directory")
    p_cmp.add_argument("--platforms",
                       help="the device type the program runs on, cuda or "
                            "cpu (default: --device's); a torch program is "
                            "traced there, so cuda needs a card")
    p_cmp.add_argument("--score-thr", type=float, default=0.0)
    p_cmp.add_argument("--batch", type=int, default=1,
                       help="images a serving call, fixed in the program "
                            "(1 = latency shape; bench.py's throughput "
                            "protocol uses 4)")
    _int8_flags(p_cmp, "; needs --calib-dir")
    p_cmp.add_argument("--calib-dir",
                       help="image directory for int8 PTQ calibration")
    p_cmp.add_argument("--calib-images", type=int, default=4)
    p_cmp.set_defaults(fn=cmd_compile)

    p_srv = sub.add_parser("serve", help="HTTP detection endpoint over an artifact")
    p_srv.add_argument("--compiled", required=True,
                       help="artifact directory from `compile`")
    p_srv.add_argument("--port", type=int, default=8437)
    p_srv.add_argument("--class-names",
                       help="comma list incl. bg for named detections")
    _add_device(p_srv)
    p_srv.set_defaults(fn=cmd_serve)

    p_conv = sub.add_parser(
        "convert_imageset",
        help="pack a window file / image list into a record shard")
    p_conv.add_argument("--window-file")
    p_conv.add_argument("--listfile", help="`path label` lines")
    p_conv.add_argument("--from-lmdb",
                        help="migrate an existing Caffe LMDB env")
    p_conv.add_argument("--from-leveldb",
                        help="migrate an existing Caffe LevelDB dir")
    p_conv.add_argument("--backend", default="records",
                        choices=["records", "lmdb", "leveldb"],
                        help="output format (lmdb/leveldb = Caffe "
                             "Datum databases)")
    p_conv.add_argument("--root-folder", default="")
    p_conv.add_argument("--shuffle", action="store_true")
    p_conv.add_argument("--seed", type=int, default=0)
    p_conv.add_argument("--encode", default=None,
                        help="re-encode as .png/.jpg (default: raw bytes)")
    p_conv.add_argument("--quality", type=int, default=95)
    p_conv.add_argument("-o", "--output", required=True)
    p_conv.set_defaults(fn=cmd_convert_imageset)

    p_mean = sub.add_parser(
        "compute_mean", help="dataset BGR mean (+ BlobProto output)")
    p_mean.add_argument("source",
                        help="window file, record shard, or image list")
    p_mean.add_argument("--root-folder", default="")
    p_mean.add_argument("-o", "--output", default=None,
                        help="write mean as BlobProto binaryproto")
    p_mean.set_defaults(fn=cmd_compute_mean)

    p_vbb = sub.add_parser(
        "vbb2bbgt", help="convert Caltech .vbb annotations to per-frame "
        "bbGt v3 txts (eval --dataset caltech input)")
    p_vbb.add_argument("vbb", help=".vbb file or directory tree")
    p_vbb.add_argument("--output-dir", required=True)
    p_vbb.add_argument("--stride", type=int, default=30,
                       help="frame sampling stride (devkit default 30)")
    p_vbb.add_argument("--offset", type=int, default=29,
                       help="first sampled frame index (default 29 = "
                            "I00029, the devkit 1 Hz convention)")
    p_vbb.set_defaults(fn=cmd_vbb2bbgt)

    p_feat = sub.add_parser(
        "extract_features", help="dump named activations to HDF5")
    _add_common(p_feat)
    p_feat.add_argument("--image-dir", required=True)
    p_feat.add_argument("--blobs", default="conv4_3",
                        help="comma-separated blob names")
    p_feat.add_argument("-o", "--output", required=True)
    p_feat.set_defaults(fn=cmd_extract_features)

    p_rs = sub.add_parser(
        "resize_images", help="batch resize/center-crop an image dir or "
                              "list to fixed geometry")
    p_rs.add_argument("source", help="image directory or list file")
    p_rs.add_argument("--output-dir", required=True)
    p_rs.add_argument("--width", type=int, required=True)
    p_rs.add_argument("--height", type=int, required=True)
    p_rs.add_argument("--no-crop", action="store_true",
                      help="plain resize (do not preserve aspect + crop)")
    p_rs.add_argument("--workers", type=int, default=4)
    p_rs.set_defaults(fn=cmd_resize_images)

    p_sum = sub.add_parser(
        "summary", help="layer table of a net prototxt (name/type/shape/"
                        "params)")
    p_sum.add_argument("--net", required=True)
    p_sum.add_argument("--phase", default="TRAIN",
                       choices=["TRAIN", "TEST"])
    _add_device(p_sum)
    p_sum.set_defaults(fn=cmd_summary)

    p_plot = sub.add_parser(
        "plot_log", help="plot training curves from a solve log")
    p_plot.add_argument("--log", required=True)
    p_plot.add_argument("--out", required=True, help="output .png path")
    p_plot.add_argument("--keys", default=None,
                        help="comma list of metric keys (default: loss)")
    p_plot.set_defaults(fn=cmd_plot_log)

    for kind in ("net", "solver"):
        p_up = sub.add_parser(
            f"upgrade_{kind}_proto",
            help=f"migrate a legacy {kind} prototxt to the modern schema")
        p_up.add_argument("input")
        p_up.add_argument("output", nargs="?", default=None,
                          help="output path (default: stdout)")
        p_up.set_defaults(fn=cmd_upgrade_proto, kind=kind)

    p_draw = sub.add_parser(
        "draw", help="render a net prototxt's topology to Graphviz DOT")
    p_draw.add_argument("--net", required=True, help="net prototxt path")
    p_draw.add_argument("--out", required=True, help="output .dot path")
    p_draw.add_argument("--rankdir", default="LR",
                        choices=["LR", "TB", "RL", "BT"])
    p_draw.add_argument("--phase", default=None, choices=["TRAIN", "TEST"])
    p_draw.set_defaults(fn=cmd_draw)

    p_dq = sub.add_parser("device_query", help="list the CUDA devices")
    p_dq.set_defaults(fn=cmd_device_query)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
