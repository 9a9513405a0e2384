"""mscnn_torch/parallel/ (mesh.py, distributed.py) against
mscnn_tpu/parallel/, in this process (no rank is spawned): the
counterparts of tests/test_distributed.py's six tests, `make_mesh`'s shapes
and messages against JAX's on as many devices, and the collectives on a
world-size-1 gloo group (rendezvous on a free port of 127.0.0.1; the group
is destroyed in a `finally`)."""

import socket

import jax
import numpy as np
import pytest
import torch

from mscnn_tpu.data import window_file as JW
from mscnn_tpu.parallel import distributed as JD
from mscnn_tpu.parallel import mesh as JM
from mscnn_torch.parallel import distributed as D
from mscnn_torch.parallel import mesh as M
from mscnn_torch.train import train_step as TT
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

CPU = torch.device("cpu")
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _imgs(n):
    return [JW.WindowImage(f"im_{i}.png", 3, 10, 10, np.zeros((0, 6), np.float32),
                           np.zeros((0, 4), np.float32)) for i in range(n)]


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_launcher(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def group():
    """A world-size-1 gloo group in this process."""
    D.initialize(f"127.0.0.1:{_port()}", 1, 0, device="cpu")
    try:
        yield
    finally:
        D.shutdown()


def test_initialize_single_process_noop(no_launcher):
    D.initialize()                      # no launcher environment: no group
    D.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    info = D.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info == {**info, "local_devices": torch.cuda.device_count()}


def test_initialize_bad_explicit_args_propagate(no_launcher):
    with pytest.raises(ValueError):
        D.initialize(coordinator_address="256.0.0.1:0", num_processes=-3,
                     process_id=99, device="cpu")
    with pytest.raises(ValueError):
        D.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                     device="cpu")
    if not torch.cuda.is_available():   # no device named and no card: no NCCL
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.initialize(coordinator_address=f"127.0.0.1:{_port()}",
                         num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,count", [(1, 4), (3, 10), (4, 10), (2, 1)])
def test_shard_window_file_matches_jax(n, count):
    images = _imgs(count)
    shards = [D.shard_window_file(images, process_id=p, process_count=n)
              for p in range(n)]
    assert shards == [JD.shard_window_file(images, process_id=p, process_count=n)
                      for p in range(n)]
    seen = [im.path for s in shards for im in s]
    assert sorted(seen) == sorted(im.path for im in images) and len(set(seen)) == count


def test_shard_window_file_single_process_identity(no_launcher):
    images = _imgs(4)
    assert D.shard_window_file(images) == images
    assert D.shard_window_file(images, process_id=0, process_count=1) == images


def test_global_data_parallel_mesh(no_launcher, group):
    mesh = D.global_data_parallel_mesh(device="cpu")
    assert mesh.axis_names == ("data",) and mesh.size == 1
    assert mesh.device(0) == CPU
    assert D.process_info() == {"process_index": 0, "process_count": 1,
                                "local_devices": torch.cuda.device_count(),
                                "global_devices": 1}


def test_initialize_tolerates_repeat_init(no_launcher, monkeypatch):
    """A repeat call is a no-op, in both the explicit and the launcher
    (torchrun's environment) forms."""
    port = _port()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        D.initialize(device="cpu")
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        D.initialize(device="cpu")
        D.initialize(f"127.0.0.1:{_port()}", 1, 0, device="cpu")
        assert D.world_size() == 1 and D.rank() == 0
    finally:
        D.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape,names,have", [
    ((2,), ("data",), 2), ((2, 1), ("data", "space"), 3), (None, ("data",), 3),
    ((4,), ("data",), 3), ((2, 2), ("data", "space"), 3)])
def test_make_mesh_shapes_and_errors_match_jax(shape, names, have):
    jdev = jax.devices()[:have]
    try:
        jm = JM.make_mesh(shape, names, jdev)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            M.make_mesh(shape, names, [CPU] * have)
        assert str(got.value) == str(e)
        return
    tm = M.make_mesh(shape, names, [CPU] * have)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape == dict(jm.shape) and tm.size == jm.devices.size


def test_data_parallel_mesh():
    m = M.data_parallel_mesh(3, device="cpu")
    assert m.shape == {"data": 3} and [str(d) for d in m.devices] == ["cpu"] * 3
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=r"mesh shape \(2,\) needs 2 devices, "
                           f"have {torch.cuda.device_count()}"):
            M.data_parallel_mesh(2)
    assert M.local_device_count() == torch.cuda.device_count()


def test_collectives_on_one_rank(group):
    g = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
         torch.tensor([1.5, -2.0], dtype=torch.float64), torch.tensor(3.0)]
    want = [t.clone() for t in g]
    D.all_reduce_mean_(g)
    for a, b in zip(g, want):
        assert torch.equal(a, b)
    D.broadcast_(g)
    assert D.agree([0, 1, 0]) == [0, 1, 0]
    D.barrier()


def test_mesh_rank_needs_a_group_of_the_mesh_size(no_launcher):
    two = M.make_mesh((2,), ("data",), [CPU, CPU])
    with pytest.raises(ValueError, match="needs as many ranks"):
        TT.mesh_rank(two)
    one = M.make_mesh((1,), ("data",), [CPU])
    assert TT.mesh_rank(one) == (0, CPU)
    batch = {"image": np.arange(8).reshape(4, 2), "labels": (torch.ones(4, 1),)}
    part = TT.shard_batch(batch, one)
    assert torch.equal(part["image"], torch.arange(8).reshape(4, 2))
    state = {"params": {"l": {"w": torch.ones(2)}}, "solver": {"it": torch.tensor(0)}}
    rep = TT.replicate_state(state, one)
    assert torch.equal(rep["params"]["l"]["w"], state["params"]["l"]["w"])
    assert rep["params"]["l"]["w"] is not state["params"]["l"]["w"]


def test_shard_batch_on_a_group_of_one(group):
    """Rank 0 of one takes the whole batch, numpy or tensors, the label
    maps' tuple leaf by leaf; the Mesh class over an explicit array."""
    one = M.make_mesh((1,), ("data",), [CPU])
    x = torch.arange(12).reshape(6, 2)
    got = TT.shard_batch({"x": x, "y": np.ones((6, 3)), "labels": (x, x + 1)}, one)
    assert torch.equal(got["x"], x) and torch.equal(got["labels"][1], x + 1)
    assert got["y"].dtype == torch.float64 and got["y"].shape == (6, 3)
    mesh = M.Mesh(np.array([CPU], dtype=object), ("data",))
    assert mesh.size == 1 and repr(mesh) == "Mesh(['cpu'], shape={'data': 1})"
