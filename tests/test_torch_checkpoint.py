"""The port's checkpoints against the JAX package's, on the CPU.

- blockwise 4-bit and int8 codes and absmax bit-equal to JAX's;
- ``save_model`` files (fp32, bf16 bit-exact, nf4/fp4 quantized) written
  by either package load into the other with equal tensors;
- ``save_checkpoint`` directories (Adam, SGD with momentum, Adafactor with
  factored moments, momentum and a schedule) cross both ways: after the
  load both packages take the same next step to within 1e-5, so the
  optimizer state crossed too (Adam's fp32 step count as ``opt.step``
  int32, Adafactor's optax leaves in the order of optax's tree);
- the files are plain safetensors: the ``safetensors`` package reads the
  port's and the port reads the package's (only this test imports it);
- the HF GPT-2 and Megatron converters equal JAX's;
- the commit marker, the background save, ``RESTORE_LOG``, and loads that
  copy into the tensors a step already reads.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.ops import quantization as jq
from hetu_tpu.optim import schedules as jsched
from hetu_tpu.utils import checkpoint as jckpt
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_state
from hetu_tpu_torch.ops import quantization as pq
from hetu_tpu_torch.utils import checkpoint as pckpt

KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
          num_kv_heads=2, max_seq_len=16, sp=False, dropout=0.0,
          position="rotary", norm="rmsnorm", activation="swiglu")
B, S = 4, 16


def _bits(t):
    """Bit pattern of a float tensor/array (bf16 compared bit for bit)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or \
            str(a.dtype) == "bfloat16":
        return a.view(np.int16)
    return a


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,blocksize", [
    ("nf4", 64), ("nf4", 16), ("fp4", 64), ("fp4", 32), ("int8", 256),
    ("int8", 64)])
def test_blockwise_codes_bit_equal_jax(quant, blocksize):
    rng = np.random.RandomState(3)
    x = rng.randn(37, 29).astype(np.float32)
    x[0, :blocksize] = 0.0                 # an all-zero block scales by 1
    x[1, 3] = -np.abs(x).max() * 2
    if quant == "int8":
        jc, ja = jq.quantize_int8(x, blocksize)
        pc, pa = pq.quantize_int8(torch.from_numpy(x), blocksize)
        jd = jq.dequantize_int8(jc, ja, x.shape, blocksize)
        pd = pq.dequantize_int8(pc, pa, x.shape, blocksize)
    else:
        jc, ja = jq.quantize_4bit(x, quant, blocksize)
        pc, pa = pq.quantize_4bit(torch.from_numpy(x), quant, blocksize)
        jd = jq.dequantize_4bit(jc, ja, x.shape, quant, blocksize)
        pd = pq.dequantize_4bit(pc, pa, x.shape, quant, blocksize)
    assert pc.dtype == (torch.int8 if quant == "int8" else torch.uint8)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# paired models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def state():
    jht.set_seed(9)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**KW))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return (rng.randint(0, 97, (B, S)).astype(np.int32),
            rng.randint(0, 97, (B, S)).astype(np.int32))


OPTS = {
    "adam": lambda o, s: o.AdamOptimizer(lr=1e-3),
    "sgd_momentum": lambda o, s: o.SGDOptimizer(lr=0.02, momentum=0.9),
    "adafactor": lambda o, s: o.AdafactorOptimizer(
        lr=s.cosine_schedule(1e-2, 1, 10), min_dim_size_to_factor=16,
        momentum=0.5),
}


class _Jax:
    def __init__(self, make_opt, state=None, dtype="float32"):
        with jht.graph("define_and_run", create_new=True) as g:
            self.ids = jht.placeholder("int32", (B, S), name="input_ids")
            self.labels = jht.placeholder("int32", (B, S), name="labels")
            self.model = JaxGPTLMHeadModel(JaxGPTConfig(**KW, dtype=dtype))
            self.loss = self.model(self.ids, self.labels)
            self.opt = make_opt(joptim, jsched)
            self.op = self.opt.minimize(self.loss)
            if state is not None:
                self.model.load_state_dict(state)
        self.g = g

    def step(self, i):
        x, y = _batch(i)
        return float(np.asarray(self.g.run(
            self.loss, [self.loss, self.op],
            {self.ids: x, self.labels: y})[0]))

    def params(self):
        return {k: np.asarray(v) for k, v in self.model.state_dict().items()}


class _Port:
    def __init__(self, make_opt, state=None, dtype="float32"):
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            self.ids = ht.placeholder("int32", (B, S), name="input_ids")
            self.labels = ht.placeholder("int32", (B, S), name="labels")
            self.model = GPTLMHeadModel(GPTConfig(**KW, dtype=dtype))
            self.loss = self.model(self.ids, self.labels)
            self.opt = make_opt(optim, optim)
            self.op = self.opt.minimize(self.loss)
            if state is not None:
                load_state(self.model, state)
        self.g = g

    def step(self, i):
        x, y = _batch(i)
        return float(self.g.run(self.loss, [self.loss, self.op],
                                {self.ids: x, self.labels: y})[0])

    def params(self):
        return {k: v.float().numpy()
                for k, v in self.model.state_dict().items()}


def _assert_params_close(got, want, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   rtol=1e-5, atol=atol, err_msg=k)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_jax_checkpoint_resumes_in_the_port(opt, state, tmp_path):
    j = _Jax(OPTS[opt], state)
    for i in range(2):
        j.step(i)
    jckpt.save_checkpoint(j.model, j.opt, str(tmp_path), step=2,
                          extra={"by": "jax"})
    p = _Port(OPTS[opt])
    ts = pckpt.load_checkpoint(p.model, p.opt, str(tmp_path),
                               verify_exempt=True)
    assert ts == {"step": 2, "extra": {"by": "jax"}}
    _assert_params_close(p.params(), j.params(), atol=0)
    # the next step needs the crossed optimizer state
    np.testing.assert_allclose(p.step(2), j.step(2), rtol=1e-5)
    _assert_params_close(p.params(), j.params())


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_port_checkpoint_resumes_in_jax(opt, state, tmp_path):
    p = _Port(OPTS[opt], state)
    for i in range(2):
        p.step(i)
    pckpt.save_checkpoint(p.model, p.opt, str(tmp_path), step=2)
    j = _Jax(OPTS[opt])
    assert jckpt.load_checkpoint(j.model, j.opt, str(tmp_path),
                                 verify_exempt=True)["step"] == 2
    _assert_params_close(p.params(), j.params(), atol=0)
    np.testing.assert_allclose(j.step(2), p.step(2), rtol=1e-5)
    _assert_params_close(p.params(), j.params())


def test_checkpoint_keys_and_types_are_jax_s(state, tmp_path):
    """Adam: ``opt.step`` int32 and fp32 moments, no ``opt.betas``; the
    Adafactor leaves by index in optax's order, shapes equal to JAX's."""
    for opt in ("adam", "adafactor"):
        j, p = _Jax(OPTS[opt], state), _Port(OPTS[opt], state)
        j.step(0)
        p.step(0)
        jckpt.save_checkpoint(j.model, j.opt, str(tmp_path / f"j{opt}"))
        pckpt.save_checkpoint(p.model, p.opt, str(tmp_path / f"p{opt}"))
        with open(tmp_path / f"j{opt}" / "index.json") as f:
            jidx = json.load(f)["tensors"]
        with open(tmp_path / f"p{opt}" / "index.json") as f:
            pidx = json.load(f)["tensors"]
        assert {k: (v["shape"], v["dtype"]) for k, v in pidx.items()} == \
            {k: (v["shape"], v["dtype"]) for k, v in jidx.items()}
        if opt == "adam":
            assert pidx["opt.step"]["dtype"] == "int32"
            assert "opt.betas" not in pidx
            assert pidx["opt.m.lm_head.weight"]["dtype"] == "float32"
        else:
            assert any("optax@@leaf" in k for k in pidx)
        # after the same step every entry holds the same values, the
        # Adafactor leaves index by index (a weight moves by about lr
        # whatever its gradient's size, so last-digit sum differences show
        # as up to 1e-3 of lr = 1e-3)
        jst = jckpt.load_split(str(tmp_path / f"j{opt}"))
        pst = pckpt.load_split(str(tmp_path / f"p{opt}"))
        for k in jst:
            np.testing.assert_allclose(pst[k].float().numpy(),
                                       np.asarray(jst[k], np.float32),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_model_crosses_both_ways(dtype, state, tmp_path):
    j = _Jax(OPTS["adam"], state, dtype=dtype)
    p = _Port(OPTS["adam"], dtype=dtype)
    jckpt.save_model(j.model, str(tmp_path / "j.safetensors"))
    pckpt.load_model(p.model, str(tmp_path / "j.safetensors"))
    jsd, psd = j.model.state_dict(), p.model.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k in jsd:
        np.testing.assert_array_equal(_bits(psd[k]), _bits(jsd[k]), k)
    p.step(0)                          # new values, then back to JAX
    pckpt.save_model(p.model, str(tmp_path / "p.safetensors"))
    jckpt.load_model(j.model, str(tmp_path / "p.safetensors"))
    jsd, psd = j.model.state_dict(), p.model.state_dict()
    for k in jsd:
        np.testing.assert_array_equal(_bits(psd[k]), _bits(jsd[k]), k)


@pytest.mark.parametrize("quant", ["nf4", "fp4"])
def test_quantized_save_crosses_both_ways(quant, state, tmp_path):
    j, p = _Jax(OPTS["adam"], state), _Port(OPTS["adam"], state)
    jckpt.save_model(j.model, str(tmp_path / "j.st"), quantize=quant)
    pckpt.save_model(p.model, str(tmp_path / "p.st"), quantize=quant,
                     dtype="bfloat16")
    jckpt.save_model(j.model, str(tmp_path / "jb.st"), quantize=quant,
                     dtype="bfloat16")
    for src in ("j.st", "jb.st", "p.st"):
        want = jckpt.safetensors_io._read_file(str(tmp_path / src))
        got = pckpt.safetensors_io._read_file(str(tmp_path / src))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32), k)
    # the port's bf16 file with quantize= equals JAX's byte for byte (JAX
    # stores bf16 tensors whole even then)
    a, _ = pckpt.read_safetensors(str(tmp_path / "p.st"))
    b, _ = pckpt.read_safetensors(str(tmp_path / "jb.st"))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_files_are_plain_safetensors(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(3, 5).astype(np.float32),
              "b": np.arange(7, dtype=np.int32), "c": np.array(2.5, np.float32),
              "d": rng.randint(0, 255, (4, 2)).astype(np.uint8)}
    pckpt.write_safetensors(str(tmp_path / "p.st"), arrays, {"k": "v"})
    back = st_np.load_file(str(tmp_path / "p.st"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    st_np.save_file(arrays, str(tmp_path / "s.st"), metadata={"k": "v"})
    got, meta = pckpt.read_safetensors(str(tmp_path / "s.st"))
    assert meta == {"k": "v"}
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    # a bf16 tensor goes in as U16 with its dtype in the metadata, as the
    # JAX package writes it
    sd = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    pckpt.save_model(sd, str(tmp_path / "bf16.st"))
    with open(tmp_path / "bf16.st", "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert header["w"]["dtype"] == "U16"
    assert header["__metadata__"]["w.dtype"] == "bfloat16"
    assert n % 8 == 0


def test_hf_converters_equal_jax():
    rng = np.random.RandomState(1)
    hf = {"transformer.wte.weight": rng.randn(11, 6),
          "transformer.wpe.weight": rng.randn(8, 6),
          "transformer.ln_f.weight": rng.randn(6),
          "transformer.ln_f.bias": rng.randn(6)}
    for name, shape in (("ln_1.weight", (6,)), ("ln_1.bias", (6,)),
                        ("ln_2.weight", (6,)), ("ln_2.bias", (6,)),
                        ("attn.c_attn.weight", (6, 18)),
                        ("attn.c_attn.bias", (18,)),
                        ("attn.c_proj.weight", (6, 6)),
                        ("attn.c_proj.bias", (6,)),
                        ("mlp.c_fc.weight", (6, 24)),
                        ("mlp.c_fc.bias", (24,)),
                        ("mlp.c_proj.weight", (24, 6)),
                        ("mlp.c_proj.bias", (6,)), ("attn.bias", (1, 1))):
        hf[f"transformer.h.0.{name}"] = rng.randn(*shape)
    for tie in (True, False):
        want = jckpt.hf_gpt2_to_ht(hf, tie_embeddings=tie)
        got = pckpt.hf_gpt2_to_ht(hf, tie_embeddings=tie)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    back_j, back_p = jckpt.ht_to_hf_gpt2(want), pckpt.ht_to_hf_gpt2(want)
    assert sorted(back_j) == sorted(back_p)
    for k in back_j:
        np.testing.assert_array_equal(back_p[k], back_j[k])
    w = rng.randn(18, 5)
    inter = pckpt.megatron_qkv_to_interleaved(w, 3)
    np.testing.assert_array_equal(inter,
                                  jckpt.megatron_qkv_to_interleaved(w, 3))
    np.testing.assert_array_equal(pckpt.interleaved_qkv_to_megatron(inter, 3),
                                  w)


def test_split_marker_background_and_restore_log(state, tmp_path):
    p = _Port(OPTS["adam"], state)
    p.step(0)
    d = str(tmp_path / "ck")
    pckpt.save_checkpoint(p.model, p.opt, d, step=1, num_shards=3)
    assert sorted(f for f in os.listdir(d) if f.endswith(".safetensors")) \
        == [f"model_{i:05d}-of-00003.safetensors" for i in range(3)]
    # JAX reads the sharded directory too
    jsplit = jckpt.load_split(d)
    psplit = pckpt.load_split(d)
    assert sorted(jsplit) == sorted(psplit)
    for k in jsplit:
        np.testing.assert_array_equal(psplit[k].numpy(), np.asarray(jsplit[k]))
    # a re-save drops the old marker before writing and restores it after
    handle = pckpt.save_checkpoint(p.model, p.opt, d, step=5,
                                   background=True)
    handle.wait(60)
    assert handle.done()
    with open(os.path.join(d, "trainer_state.json")) as f:
        assert json.load(f)["step"] == 5
    assert sorted(f for f in os.listdir(d) if f.endswith(".safetensors")) \
        == ["model_00000-of-00001.safetensors"]
    n = len(pckpt.restore_records(d))
    assert pckpt.load_checkpoint(p.model, p.opt, d)["step"] == 5
    recs = pckpt.restore_records(d)
    assert len(recs) == n + 1 and recs[-1]["verified"] is False


def test_load_copies_into_the_tensors_a_step_reads(state, tmp_path):
    """A load after training writes into the same storage (a captured
    step keeps reading it) and the next step trains the loaded values."""
    p = _Port(OPTS["adam"], state)
    p.step(0)
    pckpt.save_checkpoint(p.model, p.opt, str(tmp_path), step=1)
    before = p.step(1)
    ptrs = {n: t.get_data().data_ptr() for n, t in p.model.named_parameters()}
    mptr = {tid: m.data_ptr() for tid, m in p.opt._state["m"].items()}
    step_ptr = p.opt._state["step"].data_ptr()
    pckpt.load_checkpoint(p.model, p.opt, str(tmp_path))
    assert ptrs == {n: t.get_data().data_ptr()
                    for n, t in p.model.named_parameters()}
    assert mptr == {tid: m.data_ptr() for tid, m in p.opt._state["m"].items()}
    assert p.opt._state["step"].data_ptr() == step_ptr
    assert float(p.opt._state["step"]) == 1.0
    assert p.step(1) == before


def test_run_accepts_save_checkpoint(state):
    """``run(..., save_checkpoint=True)`` is accepted and, as in the JAX
    package, writes nothing itself."""
    p = _Port(OPTS["sgd_momentum"], state)
    x, y = _batch(0)
    out = p.g.run(p.loss, [p.loss, p.op], {p.ids: x, p.labels: y},
                  save_checkpoint=True)
    assert out[1] is None and np.isfinite(float(out[0]))
