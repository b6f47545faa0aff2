"""The training entry point's pipelined layouts
(``examples/train_gpt_torch.py --pp``), on the CPU at a tiny size.

``--pp 2`` launches 2 stage ranks and ``--pp 2 --dp 2 --zero 1`` 4
ranks through the port's launcher, as does ``--ds-config`` with 2
stages; each trains a ``GPTPipelineModel`` from the one-process run's
saved weights (the plain model's layers stacked into stages on
``--load``) and matches that run's losses (fp32, within 1e-4).  A
pipelined run's ``--save`` holds the gathered stacked state, which a
one-process run and another pipelined run resume from at its loss.
"""
import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hidden", "32", "--layers", "2", "--heads",
        "4", "--seq-len", "16", "--vocab-size", "128", "--global-batch",
        "4", "--log-every", "2", "--launch-timeout", "120"]


@pytest.fixture(scope="module")
def entry():
    spec = importlib.util.spec_from_file_location(
        "train_gpt_torch", os.path.join(REPO, "examples",
                                        "train_gpt_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def single(entry, tmp_path_factory):
    """The one-process run (plain model) from one saved file."""
    path = str(tmp_path_factory.mktemp("entry_pp") / "w.safetensors")
    entry.main(TINY + ["--steps", "1", "--save", path])
    return path, entry.main(TINY + ["--steps", "4", "--load", path])


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # the launched ranks inherit it: a thread each on the shared cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _ds_config(tmp_path):
    from hetu_tpu_torch.utils.ds_config import (generate_gpt_3d_config,
                                                save_ds_config)
    path = str(tmp_path / "ds.json")
    save_ds_config(generate_gpt_3d_config(2, 1, 1, 2, zero=False), path)
    return ["--ds-config", path]


@pytest.mark.parametrize("flags,layout", [
    (["--pp", "2"], (1, 1, 2, 0)),
    (["--pp", "2", "--dp", "2", "--zero", "1"], (2, 1, 2, 1)),
    (None, (1, 1, 2, 0))])
def test_pipelined_layouts_match_one_process(entry, single, tmp_path, flags,
                                             layout):
    path, want = single
    flags = flags if flags is not None else _ds_config(tmp_path)
    got = entry.main(TINY + ["--steps", "4", "--load", path,
                             "--micro-batch", "1"] + flags)
    lay = got["layout"]
    assert (lay["dp"], lay["tp"], lay["pp"], lay["zero"]) == layout
    assert lay["backend"] == "gloo" and not got["captured"]
    assert got["micro_batches"] == 4 // layout[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-4)


def test_stacked_state_saves_and_resumes(entry, single, tmp_path):
    """``--save`` of a pipelined run gathers every stage; a one-process
    run (its plain model) and a pipelined run resume at its loss."""
    path, _ = single
    out = str(tmp_path / "pp.safetensors")
    r = entry.main(TINY + ["--steps", "2", "--pp", "2", "--micro-batch",
                           "2", "--load", path, "--save", out])
    from hetu_tpu_torch.utils.checkpoint import read_model
    state = read_model(out)
    assert state["blk_qkv"].shape == (2, 1, 96, 32)
    plain = entry.main(TINY + ["--steps", "1", "--load", out])
    piped = entry.main(TINY + ["--steps", "1", "--load", out, "--pp", "2",
                               "--micro-batch", "2"])
    for got in (plain, piped):
        np.testing.assert_allclose(got["losses"][0],
                                   r["saved_first_batch_loss"], rtol=0,
                                   atol=1e-5)
