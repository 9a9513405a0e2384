"""The port's tools commands (mscnn_torch/cli.py) against the JAX CLI's
(mscnn_tpu/cli.py) on committed inputs.

`tests/assets/tools_ref/make_fixtures.py` names the cases: `resize_images`
over the eight KITTI scenes with and without the crop, `convert_imageset
--encode .jpg` of their window file to a record shard, an LMDB and a
LevelDB, `summary` (the port's with `--device cpu`), `draw`,
`upgrade_net_proto` / `upgrade_solver_proto` and `vbb2bbgt`. Both CLIs run
every case once (a module fixture each, in this process); for each case
the exit codes, the printed lines and every file written are equal, and
equal to the manifest that chip_smoke.py holds the card's machine to.
`plot_log` writes the same PNG pixels. Without matplotlib `plot_log`
raises ImportError naming it. The two parsers take the same subcommands
with the same options and defaults, apart from the port's `--device`.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from mscnn_tpu import cli as JCLI
from mscnn_torch import cli as TCLI
from mscnn_torch.data import image_io
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "tools_ref")
_spec = importlib.util.spec_from_file_location(
    "tools_ref_fixtures", os.path.join(ASSETS, "make_fixtures.py"))
MF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MF)
with open(os.path.join(ASSETS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
PORT_EXTRA = {"summary_v0": ["--device", "cpu"],
              "summary_lenet": ["--device", "cpu"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case with each CLI, once; the files go when the module ends."""
    res = {}
    for tag, main, extra in (("jax", JCLI.main, None),
                             ("port", TCLI.main, PORT_EXTRA)):
        out = str(tmp_path_factory.mktemp(f"tools_{tag}"))
        res[tag] = MF.run_cases(main, out, extra)
        shutil.rmtree(out)
    return res


@pytest.mark.parametrize("case,outputs", [(c[0], c[2]) for c in MF.cases()])
def test_case_matches_jax_and_manifest(runs, case, outputs):
    got, want = runs["port"][case], runs["jax"][case]
    assert got["rc"] == want["rc"] == 0
    assert got["stdout"] == want["stdout"]
    assert got["files"] == want["files"]
    assert bool(got["files"]) == bool(outputs)
    assert want == MANIFEST[case]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_plot_log_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    log = str(tmp_path / "train.log")
    MF.write_log(log)
    res = []
    for tag, main in (("j", JCLI.main), ("t", TCLI.main)):
        png = str(tmp_path / f"{tag}.png")
        rc, out = _run(main, ["plot_log", "--log", log, "--out", png, "--keys",
                              "loss,train_loss_cls,test_accuracy,missing"])
        res.append((rc, out.replace(png, "OUT"), image_io.imread(png)))
    (jrc, jout, jimg), (trc, tout, timg) = res
    assert trc == jrc == 0 and tout == jout
    assert "(no values for 'missing'" in tout
    np.testing.assert_array_equal(timg, jimg)
    empty = tmp_path / "empty.log"
    empty.write_text("nothing to plot\n")
    argv = ["plot_log", "--log", str(empty), "--out", str(tmp_path / "e.png")]
    assert _run(TCLI.main, argv) == _run(JCLI.main, argv) == \
        (1, "no iterations found in log\n")


def test_plot_log_without_matplotlib(tmp_path, monkeypatch):
    log = str(tmp_path / "train.log")
    MF.write_log(log)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot_log.*matplotlib"):
        TCLI.main(["plot_log", "--log", log, "--out", str(tmp_path / "x.png")])


def test_vbb2bbgt_without_vbbs_and_summary_without_a_card(tmp_path):
    argv = ["vbb2bbgt", str(tmp_path), "--output-dir", str(tmp_path / "o")]
    assert _run(TCLI.main, argv) == _run(JCLI.main, argv)
    assert _run(TCLI.main, argv)[0] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCLI.main(["summary", "--net", os.path.join(ASSETS, "v0_net.prototxt")])


class _Parsed(Exception):
    pass


def _parser(main, monkeypatch):
    """The ArgumentParser a CLI's main builds."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main([])
    return e.value.args[0]


def _options(parser):
    """{subcommand: {option strings or dest: (default, choices, nargs,
    required, type name)}}"""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {(tuple(a.option_strings) or a.dest):
                   (a.default, tuple(a.choices or ()), a.nargs, a.required,
                    getattr(a.type, "__name__", None))
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


# The port's own option: every command that touches the model or the
# device takes --device (the card unless it names another).
PORT_ONLY = {("--device",)}


def test_parsers_take_the_same_commands_and_options(monkeypatch):
    jax_opts = _options(_parser(JCLI.main, monkeypatch))
    port_opts = _options(_parser(TCLI.main, monkeypatch))
    assert sorted(port_opts) == sorted(jax_opts)
    for name, jo in jax_opts.items():
        po = {k: v for k, v in port_opts[name].items() if k not in PORT_ONLY}
        assert po == jo, name
    assert "--device" in {o for k in port_opts["summary"] for o in k}
    assert "--device" in {o for k in port_opts["extract_features"] for o in k}
