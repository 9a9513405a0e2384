"""mscnn_torch/io/aot.py: the torch.export deploy artifact.

The tiny config (fc_dim 256) with nonzero biases (JAX's `init_params`
plus seeded biases, carried across by `io/bridge.py`): the port's artifact is
exported, saved, loaded and run on the CPU, where its operators run their
plain versions, so it must equal the port's own `detect` / `detect_batch`
/ `detect_cascade` bit for bit (the same ATen ops in the same order). It
is held to JAX's artifact (`mscnn_tpu.io.aot`) on the same weights within
rtol / atol 1e-5 (tests/test_aot.py:68's tolerance), the batch-2 artifact
with a padded tail within 1e-4 (tests/test_aot.py:94's), the absolute term
scaled by max|ref| as in tests/test_torch_deploy.py (`assert_close`). The exported
graph must hold the `mscnn::` operators as nodes (the cascade, int8 and
bf16 programs: tests/test_torch_aot_variants.py), and a fresh process
must load and run the artifact with no `mscnn_torch.models`, `jax` or
`mscnn_tpu` module imported. Each JAX export runs once (module fixtures).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu import inference as JI
from mscnn_tpu.io import aot as JA
from mscnn_tpu.models import mscnn as JM
from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import quant as JQ
from mscnn_torch import inference as TI
from mscnn_torch.io import aot as TA
from mscnn_torch.io import bridge
from mscnn_torch.models import zoo as TZ
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

KEYS = ("boxes", "scores", "valid", "proposals", "proposal_scores",
        "proposal_valid")
SPEC_T = TI.DetectSpec(max_per_class=8)
SPEC_J = JI.DetectSpec(max_per_class=8)


def nonzero_biases(pj, seed=1):
    rng = np.random.RandomState(seed)
    return {n: {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.05)
                    if k == "b" else v) for k, v in p.items()}
            for n, p in pj.items()}


@pytest.fixture(autouse=True)
def _drop_artifacts(tmp_path):
    """Each test's files go when it ends: a tiny artifact still holds
    ~110 MB of weights (the trunk has VGG16's widths)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tiny():
    # fc_dim 256 keeps each artifact's weights ~2 MB (4096: ~210 MB of fc6)
    cfg_j = dataclasses.replace(JZ.tiny_test_config(), fc_dim=256)
    cfg_t = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    pj = nonzero_biases(JM.init_params(jax.random.key(0), cfg_j))
    pt = bridge.from_jax_params(jax.tree.map(np.asarray, pj), cfg_t)
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """The port's and JAX's batch-1 and batch-2 artifacts of the tiny model."""
    cfg_j, cfg_t, pj, pt = tiny
    root = tmp_path_factory.mktemp("aot")
    out = {}
    for b in (1, 2):
        out[f"t{b}"] = TA.export_deploy(pt, cfg_t, str(root / f"t{b}"), spec=SPEC_T,
                                        batch=b)
        out[f"j{b}"] = JA.export_deploy(pj, cfg_j, str(root / f"j{b}"), spec=SPEC_J,
                                        batch=b)
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def loaded_t1(artifacts):
    """The port's batch-1 artifact, loaded once for the module."""
    return TA.load_deploy(artifacts["t1"])


def images(seed, n, shapes=((64, 96), (80, 120), (60, 90))):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, shapes[i % len(shapes)] + (3,)).astype(np.uint8)
            for i in range(n)]


def assert_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_close(got, want, tol, keys=KEYS):
    """Port against JAX: the valid flags exactly, the values within rtol
    `tol` and atol `tol` x max(|want|, 1), as tests/test_torch_deploy.py
    scales its absolute term (the frameworks sum the convolutions in
    different orders: a box coordinate of 2.3 px differs by 4.3e-5 px)."""
    for k in keys:
        if want[k].dtype == bool:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            scale = max(float(np.abs(want[k]).max(initial=0.0)), 1.0)
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol * scale,
                                       err_msg=k)


def test_params_round_trip_keeps_bf16_and_int8(tmp_path):
    tree = {"conv": {"w": torch.randn(2, 3).to(torch.bfloat16) * 1.5,
                     "b": torch.arange(3, dtype=torch.float32),
                     "x_s": torch.tensor(0.125)},
            "inception_3a/1x1": {"w_q": torch.randint(-127, 128, (4, 3, 3, 2),
                                                      dtype=torch.int8)}}
    n = TA.save_params(tree, str(tmp_path / "p.npz"), str(tmp_path / "p.json"))
    assert n == 4
    back = TA.load_params(str(tmp_path / "p.npz"), str(tmp_path / "p.json"))
    assert list(back) == list(tree)
    for name, p in tree.items():
        assert list(back[name]) == list(p)
        for k, v in p.items():
            assert back[name][k].dtype == v.dtype and back[name][k].shape == v.shape
            assert torch.equal(back[name][k], v), (name, k)


def test_jax_artifact_params_load_through_the_bridge(tiny, tmp_path):
    """JAX's params.npz / params_meta.json (int8 trunk, bf16 float leaves)
    read by the port without ml_dtypes and converted by the bridge: the
    port's params bit for bit."""
    _, _, pj, _ = tiny
    rng = np.random.RandomState(0)
    q = JQ.quantize_trunk(pj, {n: float(rng.uniform(0.01, 0.1)) for n in JQ.TRUNK_INT8})
    q = {n: {k: v.astype(jnp.bfloat16) if k == "w" else v for k, v in p.items()}
         for n, p in q.items()}
    JA.save_params(q, str(tmp_path / "params.npz"), str(tmp_path / "params_meta.json"))
    got = bridge.from_jax_params(TA.load_params(str(tmp_path / "params.npz"),
                                                str(tmp_path / "params_meta.json")))
    n_bf16 = n_int8 = 0
    for name, p in q.items():
        for k, v in p.items():
            a = np.asarray(v)
            want = bridge.leaf_to_port(a.astype(np.float32) if a.dtype == jnp.bfloat16
                                       else a, k)
            if a.dtype == jnp.bfloat16:
                want, n_bf16 = want.to(torch.bfloat16), n_bf16 + 1
            n_int8 += a.dtype == np.int8
            g = got[name][k]
            assert g.dtype == want.dtype and g.shape == want.shape, (name, k)
            assert torch.equal(g, want), (name, k)
    assert n_bf16 > 10 and n_int8 > 10


def test_export_load_detect(tiny, artifacts, loaded_t1):
    """Batch 1: the artifact equals the port's detect bit for bit and JAX's
    artifact within 1e-5; the graph holds the NMS operator as nodes."""
    cfg_j, cfg_t, pj, pt = tiny
    for f in ("deploy.pt2", "params.npz", "params_meta.json", "meta.json"):
        assert os.path.isfile(os.path.join(artifacts["t1"], f)), f
    compiled = loaded_t1
    meta = compiled.meta
    assert meta["format"] == "mscnn-torch-aot-v1"
    assert meta["platforms"] == ["cpu"] and meta["input_hw"] == [64, 96]
    assert meta["torch_version"] == torch.__version__
    nodes = [n for n in compiled.program.graph.nodes
             if n.op == "call_function" and str(n.target) == "mscnn.nms_xywh.default"]
    assert len(nodes) == 2       # propose, and the per-class postprocess
    assert meta["kernel_ops"] == {"mscnn.nms_xywh.default": 2}
    jax_compiled = JA.load_deploy(artifacts["j1"])
    e2e = TI.make_e2e_forward(pt, cfg_t, SPEC_T)
    for img in images(0, 2):
        got = compiled.detect(img)
        assert_equal(got, TI.detect(pt, img, cfg_t, SPEC_T, e2e_fwd=e2e))
        assert_close(got, jax_compiled.detect(img), 1e-5)


def test_batched_artifact_padded_tail(tiny, artifacts):
    """Batch 2, three images (one padded group): bit for bit the port's
    detect_batch, within 1e-4 of JAX's batch-2 artifact."""
    _, cfg_t, _, pt = tiny
    compiled = TA.load_deploy(artifacts["t2"])
    assert compiled.batch == 2
    imgs = images(1, 3)
    got = compiled.detect_many(imgs)
    assert len(got) == 3
    ref = TI.detect_batch(pt, imgs[:2], cfg_t, SPEC_T) + \
        TI.detect_batch(pt, [imgs[2], imgs[2]], cfg_t, SPEC_T)[:1]
    want_j = JA.load_deploy(artifacts["j2"]).detect_many(imgs)
    for g, r, j in zip(got, ref, want_j):
        assert_equal(g, r)
        assert_close(g, j, 1e-4)
    assert_equal(compiled.detect(imgs[0]), got[0])


def test_artifact_runs_without_model_code(artifacts, loaded_t1, tmp_path, few_threads):
    """A fresh process loads the artifact and detects with no
    mscnn_torch.models, jax or mscnn_tpu module imported, and gives the
    result this process gives."""
    img = images(9, 1)[0]
    np.save(tmp_path / "img.npy", img)
    want = loaded_t1.detect(img)
    code = (
        "import json, sys, numpy as np, torch\n"
        f"torch.set_num_threads({few_threads})\n"
        "from mscnn_torch.io import aot\n"
        f"c = aot.load_deploy({artifacts['t1']!r})\n"
        f"det = c.detect(np.load({str(tmp_path / 'img.npy')!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, **det)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mscnn_tpu')"
        " or m.startswith('mscnn_torch.models'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    got = dict(np.load(tmp_path / "out.npz"))
    assert_equal(got, want)
