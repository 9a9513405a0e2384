"""The ROI example drivers' variant functions against the JAX drivers', on
the CPU.

`mscnn_torch/examples/profile_roi_variants.py`'s `table_positions`,
`pool_vect`, `pool_flatgather` and `pool_merged`, and
`profile_cascade_roi_chunk.py`'s `chunked_roi_head` / `cascade_chunked`,
each against the function of the same name in the JAX driver
(`examples/*.py`, loaded from its file), on the same seeded numpy inputs
(a small table, proposals across it, some invalid, two images).
Tolerances:
  * the sample positions and the empty-bin masks: equal;
  * every pool (a max of gathers, float32): equal to JAX's, and to the
    production pool `ops/roi.py::roi_max_pool_fast` (the drivers' maxerr
    0); the merged pool equal to JAX's production org and ctx pools;
  * the chunked ROI head against JAX's (the frameworks sum roi_c1 and fc6
    in different orders): within 1e-4 relative plus 1e-4 of max|ref|, the
    deploy graph's tolerance (tests/test_torch_cascade.py);
  * the chunked heads against the port's unsplit `M.roi_head` and the
    cascade's production forward: equal, bit for bit, in float32 and in
    bf16 (the gathers are elementwise and every later layer sees the same
    rows in the same order);
  * `profile_roi_batch.pools_per_image` against the batched pools: equal.
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.models import zoo as JZ
from mscnn_tpu.ops import roi as JR
from mscnn_torch import inference as TI
from mscnn_torch.examples import common as X
from mscnn_torch.examples import profile_cascade_roi_chunk as TCK
from mscnn_torch.examples import profile_flagship_roi_chunk as TFC
from mscnn_torch.examples import profile_roi_batch as TRB
from mscnn_torch.examples import profile_roi_variants as TRV
from mscnn_torch.io import bridge
from mscnn_torch.models import cascade as TC
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.ops import roi as TR
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
B, H, W, C, R = 2, 24, 40, 16, 24


@functools.lru_cache(maxsize=None)
def jax_driver(name):
    """examples/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cfgs():
    """(JAX, port) tiny configs at fc_dim 256."""
    return (dataclasses.replace(JZ.tiny_test_config(), fc_dim=256),
            dataclasses.replace(TZ.tiny_test_config(), fc_dim=256))


@pytest.fixture(scope="module")
def inputs():
    """A [B, H, W, C] table, R proposals an image across it (a few off the
    map, a few invalid), their image indices."""
    rng = np.random.RandomState(5)
    table = rng.randn(B, H, W, C).astype(np.float32)
    scale = 0.25
    xy = rng.uniform(-8, (W + 4) / scale, (B * R, 2)).astype(np.float32)
    xy[:, 1] = rng.uniform(-8, (H + 4) / scale, B * R)
    wh = (3.0 + rng.uniform(0, 60, (B * R, 2))).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], 1)
    valid = rng.rand(B * R) > 0.15
    bidx = np.repeat(np.arange(B, dtype=np.int32), R)
    return table, rois, valid, bidx


KW = dict(spatial_scale=0.25, pooled=7, samples=4)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("pad_ratio", [0.0, 0.25])
def test_table_positions_match_jax(inputs, pad_ratio):
    table, rois, valid, bidx = inputs
    J = jax_driver("profile_roi_variants")
    want = J.table_positions(jnp.asarray(table), jnp.asarray(bidx), jnp.asarray(rois),
                             jnp.asarray(valid), KW["spatial_scale"], pad_ratio,
                             KW["pooled"], KW["samples"], 2)
    got = TRV.table_positions(t(table), t(bidx), t(rois), t(valid), KW["spatial_scale"],
                              pad_ratio, KW["pooled"], KW["samples"], 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["pool_vect", "pool_flatgather"])
def test_pool_variants_match_jax_and_production(inputs, name):
    table, rois, valid, bidx = inputs
    J = jax_driver("profile_roi_variants")
    for pr in (0.0, 0.25):
        want = getattr(J, name)(jnp.asarray(table), jnp.asarray(bidx), jnp.asarray(rois),
                                jnp.asarray(valid), pad_ratio=pr, k=2, **KW)
        got = getattr(TRV, name)(t(table), t(bidx), t(rois), t(valid), pad_ratio=pr,
                                 k=2, **KW)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        prod = TR.roi_max_pool_fast(t(table), t(bidx), t(rois), t(valid), pad_ratio=pr,
                                    table_k=2, is_table=True, **KW)
        assert torch.equal(got, prod)


def test_merged_pool_matches_jax_pools(inputs):
    """One pool_vect call over org + the rewritten ctx boxes gives JAX's
    production org and ctx pools (roi_max_pool_fast at pad_ratio 0 and
    roi_pad_ratio), bit for bit."""
    table, rois, valid, bidx = inputs
    _, cfg = tiny_cfgs()
    got = TRV.pool_merged(t(table), t(bidx), t(rois), t(valid), cfg)
    kw = dict(spatial_scale=cfg.roi_spatial_scale, pooled=cfg.roi_pooled,
              samples=max(cfg.roi_samples // 2, 2), table_k=2, is_table=True)
    for g, pr in zip(got, (0.0, cfg.roi_pad_ratio)):
        want = JR.roi_max_pool_fast(jnp.asarray(table), jnp.asarray(bidx), jnp.asarray(rois),
                                    jnp.asarray(valid), pad_ratio=pr, **kw)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_image_pools_equal_batched(inputs, dtype):
    table, rois, valid, _ = inputs
    _, cfg = tiny_cfgs()
    tb = t(table).to(dtype)
    bidx = torch.arange(B * R) // R
    got = TRB.pools_per_image(tb, t(rois), t(valid), cfg)
    want = TRB.pools_batched(tb, bidx, t(rois), t(valid), cfg)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.fixture(scope="module")
def tiny():
    """The tiny config's port params (seeded, nonzero biases) on the CPU and
    the same weights in JAX's layout."""
    jcfg, cfg = tiny_cfgs()
    params = TM.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for p in params.values():
        if "b" in p:
            p["b"] = torch.randn(p["b"].shape, generator=gen) * 0.05
    return jcfg, cfg, params, bridge.to_jax_params(params)


def test_chunked_roi_head_matches_jax(tiny):
    """`chunked_roi_head` against the JAX driver's (batch 1, 32 ROIs in
    chunks of 8) on a [1, 24, 40, 512] table."""
    jcfg, cfg, params, jparams = tiny
    rng = np.random.RandomState(6)
    table = rng.randn(1, H, W, 512).astype(np.float32)
    n = 32
    xy = rng.uniform(0, 140, (n, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(4, 50, (n, 2)).astype(np.float32)], 1)
    valid = rng.rand(n) > 0.1
    J = jax_driver("profile_cascade_roi_chunk")
    want = J.chunked_roi_head(jparams, jnp.asarray(table), jnp.asarray(rois),
                              jnp.asarray(valid), jcfg, "", 8)
    got = TCK.chunked_roi_head(params, t(table), t(rois), t(valid), cfg, "", 8)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_heads_equal_unsplit(tiny, dtype):
    """The flagship driver's chunked deploy (`deploy_chunked`, chunks of 8
    and 12 over 2 images' 32 proposals each) and `chunked_roi_head` with a
    ragged last chunk equal the production `M.roi_head`, bit for bit."""
    _, cfg, params, _ = tiny
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16" if dtype == torch.bfloat16
                              else "float32")
    p = TM.cast_params(params, dtype)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 64, 96, 3).astype(np.float32)
                         * 40)
    with torch.inference_mode():
        ref = TFC.deploy_chunked(p, x, cfg, 0)
        for chunk in (8, 12):
            got = TFC.deploy_chunked(p, x, cfg, chunk)
            assert all(g.dtype == torch.float32 and torch.equal(g, r)
                       for g, r in zip(got, ref)), chunk
        feats = TM.trunk(p, x, cfg)
        prop = TM.propose(TM.heads(p, feats, cfg), cfg)
        bidx, rois, _, valid = TM.flatten_proposals(prop)
        table = TR.sliding_max_table(TM.upsampled_roi_feature(p, feats["conv4_3"], cfg), 2)
        got = TCK.chunked_roi_head(p, table, rois, valid, cfg, "", 24, bidx)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def tiny_cascade():
    """The tiny cascade (fc_dim 256, max_out 32): port params with nonzero
    biases, JAX's layout, a seeded image."""
    jcfg, cfg = tiny_cfgs()
    from mscnn_tpu.models import cascade as JC
    jccfg, ccfg = JC.CascadeConfig(base=jcfg), TC.CascadeConfig(base=cfg)
    params = TC.init_params(torch.Generator().manual_seed(8), ccfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    for p in params.values():
        if "b" in p:
            p["b"] = torch.randn(p["b"].shape, generator=gen) * 0.05
    x = np.random.RandomState(10).randn(1, 64, 96, 3).astype(np.float32) * 40
    return jccfg, ccfg, params, bridge.to_jax_params(params), x


def test_cascade_chunked_matches_jax_and_production(tiny_cascade):
    """`cascade_chunked` (chunks of 8) against the JAX driver's, and against
    the port's production cascade forward bit for bit."""
    jccfg, ccfg, params, jparams, x = tiny_cascade
    J = jax_driver("profile_cascade_roi_chunk")
    want = jax.jit(lambda p, xx: J.cascade_chunked(p, xx, jccfg, 8))(jparams, x)
    with torch.inference_mode():
        got = TCK.cascade_chunked(params, t(x), ccfg, 8)
        ref = TI.cascade_deploy_outputs(params, t(x), ccfg)
    for g, r in zip(got, (ref["cls_pred"], ref["bbox_pred"], ref["rois"])):
        assert torch.equal(g, r)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0))


def test_roi_pool_kw_is_roi_heads():
    """The drivers' pool arguments are the ones `M.roi_head` passes."""
    _, cfg = tiny_cfgs()
    assert X.roi_pool_kw(cfg) == dict(spatial_scale=cfg.roi_spatial_scale,
                                      pooled=cfg.roi_pooled, samples=4, table_k=2,
                                      is_table=True)
