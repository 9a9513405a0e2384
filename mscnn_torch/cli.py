"""Command-line interface: `caffe train` and the two-step `train2`.

Ports the training half of `mscnn_tpu/cli.py` (`_apply_conv1`,
`_build_training`, `cmd_train`, `cmd_train2`, `_add_common`, `main`,
cli.py:24-230, :1276-1301), for the MS-CNN nets (VGG16 trunk, LFCN
heads, BoxOutput, ROI head) that the reference's model zoo trains:

    python -m mscnn_torch.cli train --solver solver_2nd.prototxt
    python -m mscnn_torch.cli train2 --solver1 solver_1st.prototxt \\
        --solver2 solver_2nd.prototxt --bf16 --uint8-input

It runs on the card unless `--device cpu` asks for the CPU; with no card
and no such request it raises. `--conv1 auto` picks the fused conv1
kernel (`pallas_conv1`, K2) on a card at bf16 unless `--int8` is set, as
the JAX CLI picks its Pallas kernel on a TPU. A cascade trainval (more
than one TRAIN ProposalTarget) trains the cascade (`models/cascade.py`),
with `--bf16` and `--conv1` applied to it too. Not ported, each raising
where the JAX CLI would take it: the generic-prototxt branch (ROADMAP
Queue 1 item 17), `--devices > 1` (item 20), the C++ data loader and
record shards (item 14c); the other subcommands are item 18.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys

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


def _build_training(args, solver_path):
    """(state, step, make_batch_source, loop spec, cfg, tspec) of a solver
    prototxt and the net it names."""
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
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 is data parallelism, not ported yet (ROADMAP "
            "Queue 1 item 20)")
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
            raise NotImplementedError(
                f"{net_path} is not an MS-CNN net: generic-prototxt training "
                f"is not ported yet (ROADMAP Queue 1 item 17, Slice D)") from e
    if args.batch_size:
        dspec = dataclasses.replace(dspec, batch_size=args.batch_size)
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
    if args.snapshot:
        state = CKPT.restore(args.snapshot, state)
    step = T.make_train_step(cfg, tspec, sspec, lr_mults=lr_mults,
                             decay_mults=M.param_decay_multipliers(params, cfg),
                             loss_function=loss_function)

    def make_batch_source():
        return NL.make_loader(window_file, aug, dspec,
                              root_folder=args.root_folder, device=dev)

    return state, step, make_batch_source, lspec, cfg, tspec


def cmd_train(args):
    from mscnn_torch.train import loop as LP

    state, step, make_batch_source, lspec, _, _ = \
        _build_training(args, args.solver)
    if args.iterations:
        lspec = dataclasses.replace(lspec, max_iter=args.iterations)
    with make_batch_source() as src:
        LP.solve(step, state, src.get, lspec, seed=args.seed)
    print("Optimization Done.")
    return 0


def cmd_train2(args):
    """Two-step schedule (train_mscnn.sh): stage 1, then stage 2
    warm-started from stage 1's final snapshot."""
    from mscnn_torch.config import prototxt as PB
    from mscnn_torch.io import checkpoint as CKPT

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


def _add_common(p):
    p.add_argument("--model", help="trainval prototxt (overrides solver's net:)")
    p.add_argument("--weights", help="snapshot to warm-start params from")
    p.add_argument("--snapshot", help="snapshot to resume full state from")
    p.add_argument("--snapshot-prefix", default=None)
    p.add_argument("--window-file", help="override the net's data source path")
    p.add_argument("--root-folder", default="", help="image path prefix")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel width (only 1 is ported)")
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--conv1", default="auto",
                   choices=["auto", "plain", "s2d", "pallas"],
                   help="conv1 strategy (auto: the fused conv1 kernel on a "
                        "card at bf16, else plain)")
    p.add_argument("--uint8-input", action="store_true",
                   help="ship raw uint8 image canvases and normalize on "
                        "the device (bit-identical; 4x less host->device "
                        "traffic)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on "
                        "the CPU)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="mscnn_torch", description="MS-CNN training on the card")
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
