"""The deploy example drivers on the CPU: the widerface variant functions
against the JAX drivers', and what every driver shares.

`mscnn_torch/examples/profile_widerface_stages.py::propose_prebranch_topk`
and `profile_widerface_budget.py`'s `heads_merged` and `decode_only`, each
against the function of the same name in the JAX driver (`examples/*.py`,
loaded from its file), on the same seeded numpy head outputs or source
maps of widerface/mscnn-12s-2x at 128x128 with max_nms_num 100 (so that
the per-branch top-k cuts the 5 stride-8 branches). Tolerances:
  * decode and propose: the valid flags equal, boxes and scores within
    1e-4 relative plus 1e-4 of max|ref| (XLA fuses the decode's
    multiply-adds, the port rounds each; tests/test_torch_deploy.py);
  * the merged heads: within 1e-4 relative plus 1e-4 of max|ref| of JAX's
    (the frameworks sum the convolution in different orders), and within
    1e-5 of max|ref| of the port's per-branch `M.heads`;
  * the pre-top-k propose: equal, bit for bit, to the port's `M.propose`
    on the same head outputs (the drivers' `prebranch_equal`).
Then: every driver's `main()` that needs a card raises "no CUDA device"
without one, `profile_stages_8s768` routes conv1 by MSCNN_CONV1 alone, and
importing every driver loads no jax, mscnn_tpu or cv2.
"""

import dataclasses
import functools
import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscnn_tpu.models import zoo as JZ
from mscnn_torch.examples import profile_widerface_budget as TWB
from mscnn_torch.examples import profile_widerface_stages as TWS
from mscnn_torch.io import bridge
from mscnn_torch.models import mscnn as TM
from mscnn_torch.models import zoo as TZ
from mscnn_torch.train import train_step as TT
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
DRIVERS = ("profile_stages_8s768", "profile_stages_int8", "profile_int8",
           "profile_batch_stages", "profile_batch_scaling", "profile_flagship_roi_chunk",
           "profile_roi_stage", "profile_roi_batch", "profile_roi_variants",
           "profile_train_step", "profile_train_parts", "synthetic_e2e",
           "profile_cascade_roi_chunk", "profile_widerface_stages",
           "profile_widerface_budget")


@functools.lru_cache(maxsize=None)
def jax_driver(name):
    """examples/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_widerface(zoo):
    cfg = zoo.widerface_12s_2x(deploy=True, input_hw=(128, 128), max_out=32)
    return dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal,
                                                                 max_nms_num=100))


@pytest.fixture(scope="module")
def heads():
    """(JAX config, port config, per-branch head outputs [2, h, w, C+4])."""
    jcfg, cfg = small_widerface(JZ), small_widerface(TZ)
    rng = np.random.RandomState(12)
    outs = [rng.randn(2, *TT.head_hw(cfg, br), cfg.head_channels).astype(np.float32)
            for br in cfg.branches]
    return jcfg, cfg, outs


def close(got, want):
    """The decode tolerance: valid flags equal, the rest within RTOL plus
    ATOL of max|ref|."""
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * max(np.abs(want).max(), 1.0))


def test_propose_prebranch_topk_matches_jax_and_propose(heads):
    jcfg, cfg, outs = heads
    J = jax_driver("profile_widerface_stages")
    want = jax.jit(lambda o: J.propose_prebranch_topk(o, jcfg))(
        [jnp.asarray(o) for o in outs])
    t_outs = [torch.from_numpy(o) for o in outs]
    got = TWS.propose_prebranch_topk(t_outs, cfg)
    assert int(got["valid"].sum()) > 0
    for k in ("boxes", "scores", "valid"):
        close(got[k], want[k])
    prod = TM.propose(t_outs, cfg)
    assert all(torch.equal(got[k], prod[k]) for k in ("boxes", "scores", "valid"))


@pytest.mark.parametrize("with_topk", [False, True])
def test_decode_only_matches_jax(heads, with_topk):
    jcfg, cfg, outs = heads
    J = jax_driver("profile_widerface_budget")
    want = jax.jit(lambda o: J.decode_only(o, jcfg, with_topk=with_topk))(
        [jnp.asarray(o) for o in outs])
    got = TWB.decode_only([torch.from_numpy(o) for o in outs], cfg, with_topk)
    n = sum(o.shape[1] * o.shape[2] for o in outs)
    assert got[0].shape[1] == (100 if with_topk else n)
    for g, w in zip(got, want):
        close(g, w)


def test_heads_merged_matches_jax_and_heads(heads):
    """One conv a source map (the five rpn_1_conv heads merged) against the
    JAX driver's on the same weights, and against the per-branch heads."""
    jcfg, cfg, _ = heads
    gen = torch.Generator().manual_seed(13)
    params, feats = {}, {}
    for br in cfg.branches:
        cin = 256 if br.source == "rpn_1_conv" else 128
        params[br.name] = {"w": torch.randn((cfg.head_channels, cin, *br.kernel_hw),
                                            generator=gen) * 0.05,
                           "b": torch.randn((cfg.head_channels,), generator=gen) * 0.1}
        if br.source not in feats:
            feats[br.source] = torch.randn((2, *TT.head_hw(cfg, br), cin), generator=gen)
    want = jax_driver("profile_widerface_budget").heads_merged(
        bridge.to_jax_params(params), {k: jnp.asarray(v.numpy()) for k, v in feats.items()},
        jcfg)
    got = TWB.heads_merged(params, feats, cfg)
    per_branch = TM.heads(params, feats, cfg)
    for g, w, p in zip(got, want, per_branch):
        close(g, w)
        assert float((g - p).abs().max()) <= 1e-5 * float(p.abs().max())


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_needs_a_card(name, monkeypatch):
    mod = importlib.import_module(f"mscnn_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("env, route", [(None, "pallas"), ("pallas", "pallas"),
                                        ("plain", "plain"), ("s2d", "s2d")])
def test_stages_8s768_routes_conv1_by_mscnn_conv1(env, route, monkeypatch):
    """profile_stages_8s768 takes conv1's route from MSCNN_CONV1 alone, as
    the JAX script reads it ("pallas" where it is unset), into the
    flagship config it profiles (stopped there: the run needs a card)."""
    from mscnn_torch.examples import common as X
    from mscnn_torch.examples import profile_stages_8s768 as TPS8

    if env is None:
        monkeypatch.delenv("MSCNN_CONV1", raising=False)
    else:
        monkeypatch.setenv("MSCNN_CONV1", env)
    monkeypatch.setattr(X, "require_cuda", lambda: torch.device("cpu"))
    made = []

    class Built(Exception):
        pass

    def flagship(real=X.flagship, **kw):
        made.append(real(**kw))
        raise Built

    monkeypatch.setattr(X, "flagship", flagship)
    with pytest.raises(Built):
        TPS8.main([])
    cfg, = made
    assert (cfg.pallas_conv1, cfg.s2d_conv1) == (route == "pallas", route == "s2d")
    assert cfg.input_hw == (768, 2560) and cfg.compute_dtype == "bfloat16"
    assert cfg.proposal.max_out == 256


def test_drivers_import_no_jax_or_cv2():
    code = ("import importlib, sys\n"
            f"for n in {DRIVERS!r}:\n"
            "    importlib.import_module('mscnn_torch.examples.' + n)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'mscnn_tpu', 'cv2')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
