"""mscnn_torch/io/aot.py: the artifact's other programs on the CPU.

The tiny config at fc_dim 256: the cascade, the int8 trunk + heads and
the bf16 fused-conv1 artifacts, each exported, saved, loaded and run: bit
for bit the port's eager
`detect_cascade` / int8 `detect` / bf16 `detect_batch` (the operators run
their plain versions on the CPU), with each kernel's `mscnn::` operator a
node of the graph; and the platforms rule (a torch program runs on the
device type it was traced on). The batch-1 / batch-2 artifacts against JAX's
are in tests/test_torch_aot.py.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from mscnn_torch import inference as TI
from mscnn_torch.io import aot as TA
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import quant as TQ
from test_torch_aot import SPEC_T, assert_equal, few_threads, images  # noqa: F401
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)


@pytest.fixture(autouse=True)
def _drop_artifacts(tmp_path):
    """Each test's files go when it ends: a tiny artifact still holds
    ~110 MB of weights (the trunk has VGG16's widths)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(TZ.tiny_test_config(), fc_dim=256)
    params = TM.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    rng = np.random.RandomState(1)
    for p in params.values():
        if "b" in p:
            p["b"] = torch.from_numpy(rng.randn(*p["b"].shape).astype(np.float32) * 0.05)
    return None, cfg, None, params


def test_cascade_artifact_equals_detect_cascade(tmp_path):
    from mscnn_torch.models import cascade as TC

    ccfg = TC.CascadeConfig(base=dataclasses.replace(TZ.tiny_test_config(), fc_dim=256))
    params = TC.init_params(torch.Generator().manual_seed(3), ccfg, device="cpu")
    rng = np.random.RandomState(4)
    for p in params.values():
        if "b" in p:
            p["b"] = torch.from_numpy(rng.randn(*p["b"].shape).astype(np.float32) * 0.05)
    out = TA.export_deploy(params, ccfg.base, str(tmp_path / "casc"), spec=SPEC_T,
                           cascade=ccfg)
    compiled = TA.load_deploy(out)
    assert compiled.meta["cascade"] is True
    assert compiled.meta["kernel_ops"] == {"mscnn.nms_xywh.default": 2}
    for img in images(2, 2):
        got = compiled.detect(img)
        want = TI.detect_cascade(params, img, ccfg, SPEC_T)
        for k in ("boxes", "scores", "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # detect_batch with a reused cascade forward gives the same
    batched = TI.detect_batch(params, [img], ccfg.base, SPEC_T, cascade=ccfg,
                              fwd=TI.make_cascade_forward(params, ccfg))[0]
    for k in ("boxes", "scores", "valid"):
        np.testing.assert_array_equal(batched[k], got[k], err_msg=k)


def test_int8_artifact_equals_int8_detect(tiny, tmp_path):
    """The int8 trunk + heads artifact: the int8 operator is a node of the
    graph, and the artifact equals the port's int8 detect bit for bit."""
    _, cfg_t, _, pt = tiny
    cfg8 = cfg_t
    p8 = TM.init_params(torch.Generator().manual_seed(5), cfg8, device="cpu")
    cal = np.random.RandomState(6).randn(2, 64, 96, 3).astype(np.float32) * 40
    p8 = TQ.quantize_trunk(p8, TQ.calibrate_trunk_scales(p8, cfg8, cal,
                                                         include_conv1=True))
    cfg8 = dataclasses.replace(cfg8, int8_trunk=True)
    p8 = TQ.quantize_roi_heads(p8, TQ.calibrate_roi_head_scales(p8, cfg8, cal))
    cfg8 = dataclasses.replace(cfg8, int8_roi_head=True)
    compiled = TA.load_deploy(TA.export_deploy(p8, cfg8, str(tmp_path / "i8"),
                                               spec=SPEC_T))
    ops = compiled.meta["kernel_ops"]
    assert ops["mscnn.int8_conv.default"] == 17 and ops["mscnn.nms_xywh.default"] == 2
    for img in images(7, 1):
        assert_equal(compiled.detect(img), TI.detect(p8, img, cfg8, SPEC_T))


def test_bf16_conv1_artifact_holds_the_conv1_op(tiny, tmp_path):
    """bf16 with the fused conv1 block: mscnn.conv1_pool is a node, and the
    artifact equals the eager forward bit for bit."""
    _, cfg_t, _, pt = tiny
    cfg = dataclasses.replace(cfg_t, compute_dtype="bfloat16", pallas_conv1=True)
    compiled = TA.load_deploy(TA.export_deploy(pt, cfg, str(tmp_path / "bf"),
                                               spec=SPEC_T, batch=2))
    assert compiled.meta["kernel_ops"] == {"mscnn.conv1_pool.default": 1,
                                           "mscnn.nms_xywh.default": 2}
    imgs = images(8, 2)
    for g, w in zip(compiled.detect_many(imgs), TI.detect_batch(pt, imgs, cfg, SPEC_T)):
        assert_equal(g, w)


def test_platforms(tiny, tmp_path):
    """A torch program runs on the device type it was traced on: cuda
    without a card raises (the JAX artifact can target a TPU from a CPU
    host; this one cannot), and a CPU artifact will not load for a card."""
    _, cfg_t, _, pt = tiny
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TA.export_deploy(pt, cfg_t, str(tmp_path / "c"), platforms=("cuda",))
    with pytest.raises(ValueError, match="one device type"):
        TA.export_deploy(pt, cfg_t, str(tmp_path / "c"), platforms=("cpu", "cuda"))


def test_forward_keywords_give_one_result(tiny):
    """detect's e2e_fwd= (a make_e2e_forward end-to-end forward),
    detect_batch's fwd= (a make_forward deploy forward) and the defaults
    give the same result bit for bit, and so does detect_batch's fwd= in
    its mesh form (`make_forward(mesh=)` over a one-device CPU mesh); a
    constant is made once a device."""
    _, cfg, _, params = tiny
    img = images(10, 1)[0]
    a = TI.detect(params, img, cfg, SPEC_T,
                  e2e_fwd=TI.make_e2e_forward(params, cfg, SPEC_T))
    assert_equal(a, TI.detect(params, img, cfg, SPEC_T))
    assert_equal(a, TI.detect_batch(params, [img], cfg, SPEC_T,
                                    fwd=TI.make_forward(params, cfg))[0])
    from mscnn_torch.parallel import make_mesh
    mesh = make_mesh((1,), ("data",), ["cpu"])
    assert_equal(a, TI.detect_batch(params, [img], cfg, SPEC_T,
                                    fwd=TI.make_forward(params, cfg, mesh=mesh))[0])
    assert TI.device_const((1.0, 2.0), "cpu") is TI.device_const([1, 2], "cpu")
