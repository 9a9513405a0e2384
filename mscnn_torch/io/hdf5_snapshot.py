"""HDF5 snapshot variant (the reference's `snapshot_format: HDF5`).

Ports `mscnn_tpu/io/hdf5_snapshot.py` onto the port's `io/caffemodel.py`
layout mappers, so that the files are the JAX functions' for the same
parameters and each package loads the other's (`tests/
test_torch_hdf5_snapshot.py`). The layout is Caffe's:

  weights  (`Net::ToHDF5`, net.cpp:868-922):
      /data/<layer_name>/<param_id>   float datasets in CAFFE blob layout
      (optional /diff/... is read-ignored here and never written)
  solver state  (`SGDSolver::SnapshotSolverStateToHDF5`,
  sgd_solver.cpp:279-302 + util/hdf5.cpp int/string helpers):
      /iter          [1] int32 dataset
      /learned_net   string dataset
      /current_step  [1] int32 dataset
      /history/<i>   float datasets, learnable-param order

The blobs are the `.caffemodel`'s (`caffemodel._iter_layer_blobs` over the
JAX-layout view of the port's tensors; `layouts`: a generic net's
`param_layouts()`). The files are read and written by the port's
`io/hdf5.py` (numpy), where the JAX module uses h5py.

Where the port differs from the JAX loaders: each layer's blobs map back
through `caffemodel.params_from_blobs` / `state_from_history`, as the
port's `.caffemodel` / `.solverstate` loaders do, so a BatchNorm, PReLU,
Bias or Scale layer reads back, and the history blobs after one stay
aligned. JAX's loaders keep the template's values for those layers and
misread the history after them (ROADMAP Queue 3); for convolution,
deconvolution, inner product and recurrent layers the two agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mscnn_torch.io import caffemodel as CM
from mscnn_torch.io import hdf5


def save_hdf5_weights(params, path: str, *, deconv_names=CM.DECONV_NAMES,
                      fc_after_pool: Optional[dict] = None,
                      layouts: Optional[dict] = None) -> int:
    """The port's params -> Caffe Net::ToHDF5 file. Returns layers
    written."""
    jp = CM._to_jax(params, layouts)
    if fc_after_pool is None:
        fc_after_pool = CM._infer_fc_after_pool(jp)
    n = 0
    with hdf5.File(path, "w") as f:
        data = f.create_group("data")
        for name, _ltype, blobs in CM._iter_layer_blobs(
                jp, deconv_names, fc_after_pool):
            g = data.create_group(name)
            for i, blob in enumerate(blobs):
                g.create_dataset(str(i), data=np.asarray(blob, np.float32))
            n += 1
    return n


def load_hdf5_weights(path: str, params, *, deconv_names=CM.DECONV_NAMES,
                      fc_after_pool: Optional[dict] = None,
                      layouts: Optional[dict] = None):
    """Caffe HDF5 weight file -> the port's params by layer name
    (CopyTrainedLayersFromHDF5 semantics, net.cpp:795-838: layers present
    in both are overwritten, others kept). Returns (params, report)."""
    with hdf5.File(path, "r") as f:
        data = f["data"]
        blobs = {name: [np.asarray(data[name][str(i)], np.float32)
                        for i in range(len(data[name]))]
                 for name in params if name in data and "0" in data[name]}
    return CM.params_from_blobs(blobs, params, fc_after_pool, deconv_names,
                                layouts)


def save_hdf5_solverstate(state, path: str, *, learned_net: str = "",
                          current_step: int = 0,
                          deconv_names=CM.DECONV_NAMES,
                          fc_after_pool: Optional[dict] = None,
                          layouts: Optional[dict] = None) -> int:
    """The port's solver state ({"it", "h1"(, "h2")}) -> Caffe HDF5
    .solverstate.h5. Returns the number of history blobs written."""
    h1 = CM._to_jax(state["h1"], layouts)
    if fc_after_pool is None:
        fc_after_pool = CM._infer_fc_after_pool(h1)
    n = 0
    with hdf5.File(path, "w") as f:
        f.create_dataset("iter", data=np.asarray([int(state["it"])], np.int32))
        f.create_dataset("learned_net", data=np.bytes_(learned_net))
        f.create_dataset("current_step",
                         data=np.asarray([current_step], np.int32))
        hist = f.create_group("history")
        for _name, _ltype, blobs in CM._iter_layer_blobs(
                h1, deconv_names, fc_after_pool):
            for blob in blobs:
                hist.create_dataset(str(n), data=np.asarray(blob, np.float32))
                n += 1
    return n


def load_hdf5_solverstate(path: str, state_template, *,
                          deconv_names=CM.DECONV_NAMES,
                          fc_after_pool: Optional[dict] = None,
                          layouts: Optional[dict] = None):
    """Caffe HDF5 .solverstate.h5 -> the port's solver state (positional
    history blobs in learnable-param order, RestoreSolverStateFromHDF5).
    Returns (state, iter)."""
    with hdf5.File(path, "r") as f:
        it = int(np.asarray(f["iter"]).reshape(-1)[0])
        hist_g = f["history"]
        hist = [np.asarray(hist_g[str(i)], np.float32)
                for i in range(len(hist_g))]
    return CM.state_from_history(hist, it, state_template, deconv_names,
                                 fc_after_pool, layouts), it
