"""One rank of the port's data x space step, for tests/test_torch_spmd.py.

    python tests/_torch_spmd_child.py RANK WORLD PORT IN.npz OUT.npz

A fresh interpreter that imports `torch` and `mscnn_torch` only (it
asserts that no `jax` or `mscnn_tpu` module is loaded, at the start and at
the end), joins a gloo process group of WORLD ranks on 127.0.0.1:PORT with
one intra-op thread, and runs each case of IN.npz's "meta" JSON on a
("data", "space") mesh of the case's shape over WORLD CPU ranks:
`make_train_step_spmd(...)(global batch)`, `place_state` (rank != 0 starts
from perturbed params, which rank 0's broadcast overwrites), then, for each
step, `place_batch` of the global batch and the step with the global
draws. A case with "grads" also returns `SpmdStep.grads` of its first batch
at the initial params. Out, a case at a time: the state's digest and the
metrics after each step, and on rank 0 the last state and the gradients.
Inputs and outputs are nested dicts of arrays (tests/_torch_dp_child.py's
`save_tree` / `load_tree`): IN.npz holds "params" (named sets of params),
"cases" (each case's "batches" and "draws") and "meta".
"""

import json
import sys

import numpy as np

from _torch_dp_child import _batch, _numpy, _tensors, digest, load_tree, \
    no_reference_modules, save_tree


def _model(case):
    import dataclasses

    from mscnn_torch.models import cascade as TC
    from mscnn_torch.models import zoo as TZ
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    kw = dict(case["cfg"])
    if "input_hw" in kw:
        kw["input_hw"] = tuple(kw["input_hw"])
    cfg = dataclasses.replace(TZ.tiny_test_config(), **kw)
    ccfg = None
    if case.get("cascade"):
        ccfg = TC.CascadeConfig(base=cfg)
        ccfg = dataclasses.replace(ccfg, stages=ccfg.stages[:case["cascade"]])
    return cfg, ccfg, TT.TrainSpec(**case["tspec"]), TS.SolverSpec(**case["solver"])


def run_case(rank, world, case, inp):
    """One case; inp: the whole input (its "params" sets, its "cases")."""
    from mscnn_torch.models import cascade as TC
    from mscnn_torch.models import mscnn as TM
    from mscnn_torch.parallel import make_mesh
    from mscnn_torch.parallel import spmd as SP
    from mscnn_torch.train import solver as TS

    cfg, ccfg, tspec, sspec = _model(case)
    mesh = make_mesh(tuple(case["mesh"]), ("data", "space"), ["cpu"] * world)
    params = _tensors(inp["params"][case["params"]])
    inp = inp["cases"][case["name"]]
    loss_function = None
    if ccfg is not None:
        lr_mults = TC.param_lr_multipliers(params, ccfg)
        rb = case["loss_roi_batch"]

        def loss_function(p, b, c, t, *, draws, generator, mark):
            return TC.loss_fn(p, b, ccfg, t, roi_batch=rb, draws=draws,
                              generator=generator, mark=mark)
    else:
        lr_mults = TM.param_lr_multipliers(params, cfg)
    if not case.get("frozen", True):
        lr_mults = {n: {k: 1.0 for k in p} for n, p in params.items()}
    decay = TM.param_decay_multipliers(params, cfg)
    batches = [_batch(b) for b in inp["batches"]]
    compile_for = SP.make_train_step_spmd(cfg, tspec, sspec, mesh, lr_mults=lr_mults,
                                          decay_mults=decay, loss_function=loss_function,
                                          donate=False)
    step = compile_for(batches[0])
    out = {"digest": [], "metrics": []}
    # a step without random draws (bootstrap sampling, stage 1) saves none
    draws = [_tensors(d) for d in inp.get("draws", [{}] * len(batches))]
    if case.get("grads"):
        grads, metrics = step.grads(params, SP.place_batch(batches[0], mesh),
                                    draws=draws[0])
        if rank == 0:
            out["grads"] = {n: {k: g for k, g in p.items() if g is not None}
                            for n, p in _numpy(grads).items()}
        out["grads_digest"] = digest({n: {k: g for k, g in p.items() if g is not None}
                                      for n, p in grads.items()})
        out["grads_metrics"] = _numpy(metrics)
    if not case["steps"]:
        out["stats"] = np.asarray([step.last_stats.halo_calls,
                                   step.last_stats.gather_calls])
        return out
    init = params
    if rank:   # rank 0's broadcast must overwrite whatever this rank starts from
        init = {n: {k: v + 1.0 for k, v in p.items()} for n, p in params.items()}
    state = SP.place_state({"params": init, "solver": TS.init_state(init, sspec)}, mesh)
    for batch, d in zip(batches[:case["steps"]], draws):
        state, metrics = step(state, SP.place_batch(batch, mesh), draws=d)
        out["digest"].append(digest(state))
        out["metrics"].append(_numpy(metrics))
    if rank == 0 and case["steps"]:
        out["state"] = _numpy(state)
    out["stats"] = np.asarray([] if step.last_stats is None else
                              [step.last_stats.halo_calls, step.last_stats.gather_calls])
    return out


def main():
    rank, world, port, inp_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    no_reference_modules()
    import torch

    torch.set_num_threads(1)
    from mscnn_torch.parallel import distributed as D

    inp = load_tree(inp_path)
    meta = json.loads(str(inp.pop("meta")))
    D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = {c["name"]: run_case(rank, world, c, inp) for c in meta["cases"]}
    finally:
        D.shutdown()
    no_reference_modules()
    save_tree(out_path, out)


if __name__ == "__main__":
    main()
