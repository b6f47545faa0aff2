"""The port's training entry point, ``examples/train_gpt_torch.py``, on the
CPU at a tiny size.

``main(argv)`` trains with the JAX script's log line, saves the weights
and resumes from them; from one JAX-saved weight file, on the same
synthetic batches through the native loaders, its losses equal those of
the JAX package's ``examples/train_gpt.py`` (fp32, within 1e-4 at the
printed four decimals); the mesh layouts (``--dp 2 --zero 2``, ``--tp
2 --sp``, flat state) launch two gloo ranks and match the one-process
losses; every flag of a later slice raises ``NotImplementedError``
naming its ROADMAP item (the pipelined layouts are in
``test_torch_pipeline_entry.py``).  A last test imports the
port with ``jax``, ``hetu_tpu``, ``safetensors`` and ``ml_dtypes``
blocked.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hidden", "32", "--layers", "2", "--heads",
        "4", "--seq-len", "16", "--vocab-size", "128", "--global-batch",
        "4", "--log-every", "2"]
LINE = re.compile(r"^step +(\d+) \| loss (\d+\.\d{4}) \| (\d+\.\d) ms/step "
                  r"\| (\d+\.\d+)(k|M) tok/s$")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def entry():
    return _load("train_gpt_torch",
                 os.path.join(REPO, "examples", "train_gpt_torch.py"))


def _losses(out):
    lines = [l for l in out.splitlines() if l.startswith("step")]
    for l in lines:
        assert LINE.match(l), l
    return {int(LINE.match(l).group(1)): float(LINE.match(l).group(2))
            for l in lines}


def test_trains_logs_saves_and_resumes(entry, tmp_path, capsys):
    path = str(tmp_path / "w.safetensors")
    r = entry.main(TINY + ["--steps", "6", "--save", path])
    logged = _losses(capsys.readouterr().out)
    assert sorted(logged) == [2, 4, 6]
    assert r["loader"] == "native" and r["steps"] == 6
    assert len(r["losses"]) == 6 and all(np.isfinite(r["losses"]))
    assert r["losses"][-1] < r["losses"][0]
    assert abs(logged[6] - r["losses"][-1]) < 1e-4
    assert r["timed_steps"] == 4 and r["ms_per_step"] > 0
    assert os.path.exists(path)
    fresh = entry.main(TINY + ["--steps", "1"])
    resumed = entry.main(TINY + ["--steps", "1", "--load", path])
    assert abs(resumed["losses"][0] - fresh["losses"][0]) > 1e-3
    np.testing.assert_allclose(resumed["losses"][0],
                               r["saved_first_batch_loss"], rtol=1e-6)


def test_losses_equal_the_jax_entry_point(entry, tmp_path, capsys,
                                          monkeypatch):
    import hetu_tpu as jht
    from hetu_tpu.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu.utils.checkpoint import save_model
    jht.set_seed(3)
    with jht.graph("eager", create_new=True):
        m = GPTLMHeadModel(GPTConfig(vocab_size=128, hidden_size=32,
                                     num_layers=2, num_heads=4,
                                     max_seq_len=16, sp=False))
        m.logits(np.zeros((1, 4), np.int32))
        path = str(tmp_path / "w.safetensors")
        save_model(m, path)
    argv = TINY[2:] + ["--steps", "6", "--load", path]
    jax_entry = _load("train_gpt", os.path.join(REPO, "examples",
                                                "train_gpt.py"))
    monkeypatch.setattr(sys, "argv", ["train_gpt.py"] + argv)
    jax_entry.main()
    want = _losses(capsys.readouterr().out)
    entry.main(["--device", "cpu"] + argv)
    got = _losses(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == [2, 4, 6]
    for s in want:
        assert abs(got[s] - want[s]) <= 1.5e-4, (s, got[s], want[s])


@pytest.mark.parametrize("flags,item", [
    (["--auto-parallel"], "item 16"), (["--calibrate"], "item 16"),
    (["--trace-out", "t.json"], "item 15")])
def test_flags_of_later_slices_raise(entry, flags, item, tmp_path):
    """The planner's flags raise naming item 16; ``--trace-out`` (item
    15, ported) writes the run's trace instead, one ``train_step`` span a
    step (tests/test_torch_obs_export.py holds it to JAX's validator)."""
    if item == "item 15":
        path = str(tmp_path / flags[1])
        r = entry.main(TINY + ["--steps", "2", "--trace-out", path])
        assert r["trace"]["path"] == path and r["trace"]["train_steps"] == 2
        with open(path) as f:
            assert json.load(f)["traceEvents"]
        return
    with pytest.raises(NotImplementedError, match=item):
        entry.main(TINY + ["--steps", "1"] + flags)


@pytest.fixture(scope="module")
def single(entry, tmp_path_factory):
    """The one-process run the mesh layouts are held against (the
    weights from one saved file: every layout starts from them)."""
    path = str(tmp_path_factory.mktemp("entry_mesh") / "w.safetensors")
    r = entry.main(TINY + ["--steps", "1", "--save", path])
    return path, entry.main(TINY + ["--steps", "4", "--load", path])


@pytest.mark.parametrize("flags", [["--dp", "2", "--zero", "2"],
                                   ["--tp", "2", "--sp"],
                                   ["--dp", "2", "--grad-comm", "fp32",
                                    "--flat-state", "--zero", "1"]])
def test_mesh_layouts_launch_ranks_and_match_one_process(entry, single,
                                                         flags):
    """``dp * tp > 1`` launches the ranks through the port's launcher;
    rank 0's losses equal the one-process run's (fp32, 2e-5)."""
    path, want = single
    got = entry.main(TINY + ["--steps", "4", "--load", path,
                             "--launch-timeout", "120"] + flags)
    assert got["layout"]["backend"] == "gloo" and not got["captured"]
    assert got["steps"] == 4 and len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=2e-5)


def test_ds_config_gives_the_layout(entry, tmp_path):
    from hetu_tpu_torch.utils.ds_config import (generate_gpt_3d_config,
                                                save_ds_config)
    path = str(tmp_path / "ds.json")
    save_ds_config(generate_gpt_3d_config(2, 2, 2, 1), path)
    args = entry.parse_args(TINY + ["--ds-config", path])
    assert entry.layout(args) == (2, 2, 1, 1)
    save_ds_config(generate_gpt_3d_config(2, 1, 1, 2), path)
    assert entry.layout(entry.parse_args(TINY + ["--ds-config", path])) \
        == (1, 1, 2, 1)


def test_the_port_imports_without_jax_or_safetensors():
    """Every module of the port imports with ``jax``, ``hetu_tpu``,
    ``safetensors`` and ``ml_dtypes`` blocked (a fresh interpreter)."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "hetu_tpu", "safetensors", "ml_dtypes"):
    sys.modules[name] = None
import hetu_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(hetu_tpu_torch.__path__,
                                              "hetu_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location(
    "e", "examples/train_gpt_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
need = {"hetu_tpu_torch.data.dataloader", "hetu_tpu_torch.graph.amp",
        "hetu_tpu_torch.graph.recompute", "hetu_tpu_torch.ops.fused_ce",
        "hetu_tpu_torch.optim.schedules", "hetu_tpu_torch.utils.profiler",
        "hetu_tpu_torch.utils.checkpoint.safetensors_io",
        "hetu_tpu_torch.utils.checkpoint.converters",
        "hetu_tpu_torch.utils.logging_utils"}
assert need <= set(mods), need - set(mods)
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30
