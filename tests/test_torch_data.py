"""The port's data subsystem against the JAX package's, on the CPU.

The dataloader gives JAX's batches for one seed on both paths: the native
core (``hetu_tpu_torch/csrc/dataloader.cc``, a copy of JAX's, built with
``g++`` into the port's own ``_build``) and the python path, over epochs,
with dp sharding, shuffled or not, with or without ``drop_last``.
``Bucket`` and ``ffd_pack`` give JAX's padded and packed batches, and the
datasets JAX's rows.
"""
import json
import os

import numpy as np
import pytest

from hetu_tpu import data as jdata
from hetu_tpu_torch import data as pdata
from hetu_tpu_torch.csrc import build as pbuild


def _tokens(n=4000, seed=0):
    return np.random.RandomState(seed).randint(0, 500, n)


def _epochs(loader, n=2):
    out = []
    for _ in range(n):
        for b in loader:
            out.append(b if not isinstance(b, tuple) else np.concatenate(
                [np.asarray(x).reshape(len(x), -1) for x in b], axis=1))
    return out


def test_core_builds_into_the_port_s_own_directory():
    lib = pbuild.load_dataloader_core()
    assert lib is not None
    assert os.path.dirname(lib._name) == pbuild.BUILD_DIR
    assert os.path.basename(pbuild.BUILD_DIR) == "_build" and \
        os.path.dirname(pbuild.BUILD_DIR).endswith(
            os.path.join("hetu_tpu_torch", "csrc"))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle,drop_last,dp", [
    (True, True, (0, 1)), (True, False, (1, 3)), (False, True, (0, 2)),
    (False, False, (2, 3))])
def test_same_batches_as_jax(native, shuffle, drop_last, dp):
    ds_j = jdata.GPTSeqDataset(_tokens(), seq_len=32)
    ds_p = pdata.GPTSeqDataset(_tokens(), seq_len=32)
    np.testing.assert_array_equal(ds_p.as_matrix(), ds_j.as_matrix())
    kw = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=3,
              use_native=native)
    lj = jdata.Dataloader(ds_j, **kw).set_dp_rank(*dp)
    lp = pdata.Dataloader(ds_p, **kw).set_dp_rank(*dp)
    assert (lp._lib is not None) == native
    assert len(lp) == len(lj)
    bj, bp = _epochs(lj), _epochs(lp)
    assert len(bp) == len(bj) > 0
    for a, b in zip(bp, bj):
        np.testing.assert_array_equal(a, b)
    if shuffle:
        assert not np.array_equal(bp[0], bp[len(bp) // 2])


def test_native_requested_without_a_core_raises(monkeypatch):
    from hetu_tpu_torch.data import dataloader
    monkeypatch.setattr(dataloader, "load_dataloader_core", lambda: None)
    with pytest.raises(RuntimeError, match="native dataloader requested"):
        pdata.Dataloader(pdata.GPTSeqDataset(_tokens(), 32), 4,
                         use_native=True)


def test_tensor_dataset_python_path_equals_jax():
    rng = np.random.RandomState(1)
    x, y = rng.randn(23, 3).astype(np.float32), rng.randint(0, 9, 23)
    kw = dict(batch_size=4, shuffle=True, seed=5, drop_last=False)
    bj = list(jdata.Dataloader(jdata.TensorDataset(x, y), **kw))
    bp = list(pdata.Dataloader(pdata.TensorDataset(x, y), **kw))
    assert len(bp) == len(bj) == 6
    for (px, py), (jx, jy) in zip(bp, bj):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


def test_json_dataset_equals_jax(tmp_path):
    path = tmp_path / "docs.jsonl"
    with open(path, "w") as f:
        for doc in ("a bc", "", "def gh ij", "k"):
            if doc:
                f.write(json.dumps({"text": doc}) + "\n")
            else:
                f.write("\n")
    tok = lambda s: [ord(c) for c in s]      # noqa: E731
    dj = jdata.GPTJsonDataset(str(path), "text", 6, tok, pad_id=1)
    dp = pdata.GPTJsonDataset(str(path), "text", 6, tok, pad_id=1,
                              cache_path=str(tmp_path / "cache"))
    np.testing.assert_array_equal(dp.data, dj.data)
    again = pdata.GPTJsonDataset("missing.jsonl", "text", 6, tok,
                                 cache_path=str(tmp_path / "cache"))
    np.testing.assert_array_equal(again.data, dj.data)


@pytest.mark.parametrize("lens,max_seqlen,alignment", [
    ([30, 8, 8, 8, 6], 32, 8), ([5, 17, 3, 9, 12, 1, 16], 32, 4),
    ([100, 64, 1, 63, 27, 128], 128, 16)])
def test_ffd_pack_and_bucket_equal_jax(lens, max_seqlen, alignment):
    assert pdata.ffd_pack(lens, max_seqlen, alignment) == \
        jdata.bucket.ffd_pack(lens, max_seqlen, alignment)
    buckets = []
    for mod in (jdata, pdata):
        b = mod.Bucket(pad_token=0, max_seqlen=max_seqlen,
                       alignment=alignment)
        for i, n in enumerate(lens):
            b.add_data(np.arange(1, n + 1) + i, n)
        b.pad_data()
        b.pack_data()
        buckets.append(b)
    bj, bp = buckets
    np.testing.assert_array_equal(bp.padded_batch, bj.padded_batch)
    np.testing.assert_array_equal(bp.packed_batch, bj.packed_batch)
    for a, b in zip(bp.packed_cu_seqlens_list, bj.packed_cu_seqlens_list):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(bp.padded_cu_seqlens_list, bj.padded_cu_seqlens_list):
        np.testing.assert_array_equal(a, b)


def test_batch_helpers_equal_jax():
    for mod_j, mod_p in ((jdata, pdata),):
        batch, lens = mod_p.build_fake_batch_and_len([9, 3, 6], pad_token=0)
        bj, lj = mod_j.build_fake_batch_and_len([9, 3, 6], pad_token=0)
        np.testing.assert_array_equal(batch, bj)
        sp, lp = mod_p.get_sorted_batch_and_len(batch, 0)
        sj, lj = mod_j.get_sorted_batch_and_len(bj, 0)
        np.testing.assert_array_equal(sp, sj)
        np.testing.assert_array_equal(lp, lj)
        ip, lbp = mod_p.get_input_and_label_buckets(batch, 0, [0, 2], 16, 4)
        ij, lbj = mod_j.get_input_and_label_buckets(bj, 0, [0, 2], 16, 4)
        for a, b in ((ip, ij), (lbp, lbj)):
            a.pad_data()
            b.pad_data()
            np.testing.assert_array_equal(a.padded_batch, b.padded_batch)
