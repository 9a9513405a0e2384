"""One data-parallel rank of the port, for tests/test_torch_dp_*.py.

    python tests/_torch_dp_child.py SCENARIO RANK WORLD PORT IN.npz OUT.npz

A fresh interpreter that imports `torch` and `mscnn_torch` only (it
asserts that no `jax` or `mscnn_tpu` module is loaded, at the start and at
the end), joins a gloo process group of WORLD ranks on 127.0.0.1:PORT with
one intra-op thread, runs SCENARIO on its inputs and writes its outputs.
Inputs and outputs are nested dicts of arrays flattened into .npz files
(`save_tree` / `load_tree`; a dict whose keys are all digits is a list);
IN.npz holds a "meta" JSON string too.

Scenarios:
  * step     -- the MS-CNN (or, with meta["cascade"], the cascade) train
                step with a mesh: `replicate_state` (rank != 0 starts from
                perturbed params, which rank 0's broadcast overwrites),
                then for each step `shard_batch` of the global batch and
                the step on this rank's draws; out: a digest of the state
                and the metrics after each step, and rank 0's last state;
  * eval     -- the eval step with a mesh on each global batch;
  * generic  -- `train/generic.py::setup(mesh=)` from a .caffemodel, then
                its steps on its own batch source with this rank's draws;
  * loop     -- `train/loop.py::solve` with a stand-in step: rank 0 gets a
                SIGHUP in iteration 0, rank 1 a SIGINT in iteration 2;
                out: the iteration each rank stopped at and the snapshots
                it wrote.
"""

import json
import os
import signal
import sys

import numpy as np

SEP = "/"


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}{SEP}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}{SEP}", out)
    else:
        out[prefix[:-len(SEP)]] = np.asarray(tree)


def save_tree(path, tree):
    out = {}
    _flat(tree, "", out)
    np.savez(path, **out)


def _listify(tree):
    if not isinstance(tree, dict):
        return tree
    tree = {k: _listify(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def load_tree(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split(SEP)
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return _listify(tree)


def no_reference_modules():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "mscnn_tpu"))
    assert not bad, f"a rank loaded {bad[:5]}"


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _batch(tree):
    """A batch dict: "labels" back to a tuple."""
    b = _tensors(tree)
    if "labels" in b:
        b["labels"] = tuple(b["labels"])
    return b


def _model(meta):
    import dataclasses

    from mscnn_torch.models import cascade as TC
    from mscnn_torch.models import zoo as TZ
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg = dataclasses.replace(TZ.tiny_test_config(), **meta["cfg"])
    ccfg = None
    if meta.get("cascade"):
        ccfg = TC.CascadeConfig(base=cfg)
        ccfg = dataclasses.replace(ccfg, stages=ccfg.stages[:meta["cascade"]])
    return cfg, ccfg, TT.TrainSpec(**meta["tspec"]), TS.SolverSpec(**meta["solver"])


def scenario_step(rank, mesh, inp, meta):
    import functools

    import torch

    from mscnn_torch.models import cascade as TC
    from mscnn_torch.models import mscnn as TM
    from mscnn_torch.train import solver as TS
    from mscnn_torch.train import train_step as TT

    cfg, ccfg, tspec, sspec = _model(meta)
    params = _tensors(inp["params"])
    if ccfg is not None:
        lr_mults = TC.param_lr_multipliers(params, ccfg)
        loss_function = functools.partial(
            lambda p, b, c, t, *, draws, generator, mark, rb: TC.loss_fn(
                p, b, ccfg, t, roi_batch=rb, draws=draws, generator=generator,
                mark=mark), rb=meta["loss_roi_batch"])
    else:
        lr_mults, loss_function = TM.param_lr_multipliers(params, cfg), None
    decay = TM.param_decay_multipliers(params, cfg)
    if rank:   # rank 0's broadcast must overwrite whatever rank 1 starts from
        params = {n: {k: v + 1.0 for k, v in p.items()} for n, p in params.items()}
    state = TT.replicate_state({"params": params,
                                "solver": TS.init_state(params, sspec)}, mesh)
    step = TT.make_train_step(cfg, tspec, sspec, lr_mults=lr_mults,
                              decay_mults=decay, mesh=mesh,
                              loss_function=loss_function)
    out = {"digest": [], "metrics": []}
    for batch, draws in zip(inp["batches"], inp["draws"]):
        local = TT.shard_batch(_batch(batch), mesh)
        mine = draws[rank]
        mine = [_tensors(d) for d in mine] if isinstance(mine, list) else _tensors(mine)
        state, metrics = step(state, local, draws=mine)
        out["digest"].append(digest(state))
        out["metrics"].append(_numpy(metrics))
    if rank == 0:       # the last state in full: rank 1's equals it by digest
        out["state"] = _numpy(state)
    assert all(torch.is_tensor(t) for t in state["params"]["conv3_1"].values())
    return out


def digest(tree) -> str:
    """SHA-256 of every array of the tree (keys sorted): equal digests, the
    same bits."""
    import hashlib

    flat = {}
    _flat(_numpy(tree), "", flat)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def scenario_eval(rank, mesh, inp, meta):
    from mscnn_torch.train import train_step as TT

    cfg, _, tspec, _ = _model(meta)
    step = TT.make_eval_step(cfg, tspec, mesh=mesh)
    params = _tensors(inp["params"])
    return {"metrics": [_numpy(step(params, TT.shard_batch(_batch(b), mesh),
                                    draws=_tensors(d[rank])))
                        for b, d in zip(inp["batches"], inp["draws"])]}


def scenario_generic(rank, mesh, inp, meta):
    from mscnn_torch.train import generic as TG
    from mscnn_torch.train import solver as TS

    state, step, source, _ = TG.setup(meta["net"], TS.SolverSpec(**meta["solver"]),
                                      weights=meta["weights"], mesh=mesh,
                                      device="cpu")
    out = {"state": [], "metrics": [], "batches": []}
    for draws in inp["draws"]:
        batch = source()
        state, metrics = step(state, batch, draws=_tensors(draws[rank]))
        out["state"].append(_numpy(state))
        out["metrics"].append(_numpy(metrics))
        out["batches"].append(_numpy(batch))
    return out


def scenario_loop(rank, mesh, inp, meta):
    import torch

    from mscnn_torch.train import loop as LP

    written = []
    write = LP._write_snapshot

    def record(spec, state, it):
        written.append(it)
        return write(spec, state, it)

    LP._write_snapshot = record

    def step(state, batch, *, generator):
        it = int(state["solver"]["it"])
        if rank == 0 and it == 0:
            os.kill(os.getpid(), signal.SIGHUP)
        if rank == 1 and it == 2:
            os.kill(os.getpid(), signal.SIGINT)
        draw = torch.rand((), generator=generator)
        return ({"params": {"l": {"w": state["params"]["l"]["w"] + draw}},
                 "solver": {"it": state["solver"]["it"] + 1}},
                {"loss": draw, "lr": torch.tensor(0.1)})

    spec = LP.LoopSpec(max_iter=8, display=0, snapshot=2,
                       snapshot_prefix=meta["prefix"])
    state = {"params": {"l": {"w": torch.zeros(3)}},
             "solver": {"it": torch.zeros((), dtype=torch.int64)}}
    lines = []
    final = LP.solve(step, state, lambda: None, spec, seed=3, rank=rank,
                     log=lines.append)
    return {"it": int(final["solver"]["it"]), "w": final["params"]["l"]["w"].numpy(),
            "written": np.asarray(written, np.int64), "lines": np.asarray(lines)}


def main():
    scenario, rank, world, port, inp_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    no_reference_modules()
    import torch

    torch.set_num_threads(1)
    from mscnn_torch.parallel import distributed as D
    from mscnn_torch.parallel import make_mesh

    inp = load_tree(inp_path)
    meta = json.loads(str(inp.pop("meta")))
    D.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh((world,), ("data",), ["cpu"] * world)
        out = globals()[f"scenario_{scenario}"](rank, mesh, inp, meta)
    finally:
        D.shutdown()
    no_reference_modules()
    save_tree(out_path, out)


if __name__ == "__main__":
    main()
