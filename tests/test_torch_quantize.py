"""PyTorch port, ``mxnet_tpu_torch.quantize``: the blockwise int8/fp8
core and the per-tensor serving half.

Twins of tests/test_quantize.py's ``TestCompressionSpec`` and
``TestQuantCore`` on CPU tensors, then parity with the JAX package's
``mxnet_tpu.quantize`` on the same numpy inputs: blockwise scales equal,
int8 and fp8 payloads bit for bit (fp8 over values past +-464, where the
reference's cast gives NaN and torch's own would saturate to 448),
``tensor_scale`` equal as a float, ``quantize_tensor`` bit for bit, and
``dequantize`` / ``quantize_with_feedback`` within 1e-7 of the input's
max |value|.  Stochastic int8 rounding draws from a ``torch.Generator``:
unbiased, and repeatable under one seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import quantize as jqz
from mxnet_tpu_torch import quantize as qz
from mxnet_tpu_torch.base import MXNetError

CPU = "cpu"


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).uniform(-1, 1, shape)
            * scale).astype("float32")


def _bits(t):
    """The payload's raw bytes (int8 or fp8) as uint8."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


# ---------------------------------------------------------------- spec
class TestCompressionSpec:
    def test_parse_string_and_options(self):
        spec = qz.CompressionSpec.parse("int8:block=64,stochastic=1")
        assert (spec.kind, spec.block, spec.stochastic) \
            == ("int8", 64, True)
        assert spec.error_feedback is True
        spec = qz.CompressionSpec.parse("fp8:error_feedback=0")
        assert spec.kind == "fp8" and spec.error_feedback is False

    def test_parse_dict_none_and_passthrough(self):
        assert qz.CompressionSpec.parse(None) is None
        assert qz.CompressionSpec.parse("none") is None
        spec = qz.CompressionSpec.parse({"type": "int8", "block": 32})
        assert spec.block == 32
        assert qz.CompressionSpec.parse(spec) is spec

    def test_parse_rejects_unknown(self):
        with pytest.raises(MXNetError, match="unknown kind"):
            qz.CompressionSpec.parse("int4")
        with pytest.raises(MXNetError, match="unknown params"):
            qz.CompressionSpec.parse({"type": "int8", "threshold": 1})
        with pytest.raises(MXNetError, match="malformed option"):
            qz.CompressionSpec.parse("int8:block")

    def test_fp8_stochastic_rejected_not_ignored(self):
        with pytest.raises(MXNetError, match="int8-only"):
            qz.CompressionSpec.parse("fp8:stochastic=1")

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("MXNET_KVSTORE_GRAD_COMPRESSION",
                           "int8:block=16")
        spec = qz.CompressionSpec.from_env()
        assert spec.kind == "int8" and spec.block == 16
        monkeypatch.delenv("MXNET_KVSTORE_GRAD_COMPRESSION")
        assert qz.CompressionSpec.from_env() is None

    def test_immutable_hashable(self):
        spec = qz.CompressionSpec("int8")
        with pytest.raises(AttributeError):
            spec.block = 7
        assert spec == qz.CompressionSpec("int8") \
            and hash(spec) == hash(qz.CompressionSpec("int8"))
        assert spec.qmax == 127.0 and spec.wire_dtype == torch.int8
        assert qz.CompressionSpec("fp8").wire_dtype == torch.float8_e4m3fn


# ----------------------------------------------------------- quant core
class TestQuantCore:
    @pytest.mark.parametrize("kind", ["int8", "fp8"])
    def test_roundtrip_error_bounded_by_block_scale(self, kind):
        spec = qz.CompressionSpec(kind, block=32)
        x = torch.from_numpy(_rand((40, 13), 3))
        payload, scales = qz.quantize(x, spec)
        assert payload.dtype == spec.wire_dtype
        assert scales.shape == (qz._nblocks(x.numel(), spec),)
        back = qz.dequantize(payload, scales, x.shape, x.dtype)
        step = np.repeat(scales.numpy(), spec.block)[:x.numel()]
        err = (back - x).abs().numpy().ravel()
        slack = 0.51 if kind == "int8" else 16.1
        assert (err <= step * slack + 1e-7).all()

    def test_blockwise_scales_track_local_magnitude(self):
        spec = qz.CompressionSpec("int8", block=64)
        x = torch.cat([torch.full((64,), 100.0), torch.full((64,), 1e-3)])
        _, scales = qz.quantize(x, spec)
        assert float(scales[0]) > 0.5 and float(scales[1]) < 1e-4

    def test_zero_block_survives(self):
        spec = qz.CompressionSpec("int8", block=8)
        x = torch.zeros(16)
        payload, scales = qz.quantize(x, spec)
        assert torch.equal(scales, torch.ones(2))
        assert qz.dequantize(payload, scales, x.shape,
                             x.dtype).sum().item() == 0.0

    def test_stochastic_rounding_unbiased(self):
        spec = qz.CompressionSpec("int8", block=8, stochastic=True)
        # 0.3 quantization steps above a representable point:
        # deterministic rounding always lands below; stochastic
        # averages to it
        x = torch.full((8,), 10.3 / 127.0)
        got = []
        for i in range(200):
            p, s = qz.quantize(x, spec,
                               key=torch.Generator().manual_seed(i))
            got.append(float(qz.dequantize(p, s, x.shape, x.dtype)[0]))
        assert abs(np.mean(got) - float(x[0])) < 0.1 * float(s[0])
        with pytest.raises(MXNetError, match="PRNG key"):
            qz.quantize(x, spec)

    def test_error_feedback_residual(self):
        spec = qz.CompressionSpec("int8", block=8)
        g = torch.from_numpy(_rand((8,), 1))
        res = torch.zeros(8)
        payload, scales, new_res = qz.quantize_with_feedback(g, res, spec)
        deq = qz.dequantize(payload, scales, g.shape, torch.float32)
        np.testing.assert_allclose(new_res.numpy(), (g - deq).numpy(),
                                   rtol=1e-6)
        no_ef = qz.CompressionSpec("int8", block=8, error_feedback=False)
        _, _, r2 = qz.quantize_with_feedback(g, res, no_ef)
        assert r2.sum().item() == 0.0

    def test_wire_bytes_math(self):
        spec = qz.CompressionSpec("int8", block=128)
        # 300 elems -> 3 blocks: 384 payload bytes + 12 scale bytes
        assert qz.wire_bytes(300, spec) == 3 * 128 + 3 * 4
        assert qz.logical_bytes(300, "float32") == 1200
        assert qz.logical_bytes(300, "bfloat16") == 600
        assert qz.logical_bytes(300, torch.bfloat16) == 600
        assert qz.logical_bytes(300, np.float16) == 600

    def test_tensor_quant_roundtrip(self):
        spec = qz.CompressionSpec("int8")
        w = _rand((32, 16), 5)
        scale = qz.tensor_scale(w, spec)
        q = qz.quantize_tensor(w, scale, spec, device=CPU)
        assert q.dtype == torch.int8 and q.device.type == "cpu"
        back = qz.dequantize_tensor(q, scale, torch.float32).numpy()
        assert np.abs(back - w).max() <= scale * 0.51 + 1e-7


# ------------------------------------------------ against the JAX package
PARITY_CASES = [("int8", 128, (40, 13), 1.0), ("int8", 32, (300,), 5.0),
                ("int8", 7, (6, 5, 4), 0.01), ("fp8", 128, (40, 13), 1.0),
                ("fp8", 32, (300,), 600.0), ("fp8", 7, (6, 5, 4), 0.01)]


@pytest.mark.parametrize("kind, block, shape, mag", PARITY_CASES)
def test_blockwise_matches_jax(kind, block, shape, mag):
    """Blockwise quantize of the same numpy input: scales equal, payload
    bit for bit, and dequantize within 1e-7 of max |x| of the JAX one."""
    x = _rand(shape, seed=block, scale=mag)
    x.reshape(-1)[:block] = 0.0               # an all-zero first block
    spec = qz.CompressionSpec(kind, block=block)
    jspec = jqz.CompressionSpec(kind, block=block)
    p, s = qz.quantize(x, spec, device=CPU)
    jp, js = jqz.quantize(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_bits(p), _bits(jp))
    back = qz.dequantize(p, s, shape, torch.float32).numpy()
    jback = np.asarray(jqz.dequantize(jp, js, shape, jnp.float32))
    assert np.abs(back - jback).max() <= 1e-7 * np.abs(x).max()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_feedback_residual_matches_jax(kind):
    g = _rand((50, 9), 4)
    res = _rand((50, 9), 5, scale=0.01)
    spec = qz.CompressionSpec(kind, block=16)
    p, s, r = qz.quantize_with_feedback(g, res, spec, device=CPU)
    jp, js, jr = jqz.quantize_with_feedback(
        jnp.asarray(g), jnp.asarray(res), jqz.CompressionSpec(kind, block=16))
    np.testing.assert_array_equal(_bits(p), _bits(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.abs(r.numpy() - np.asarray(jr)).max() \
        <= 1e-7 * np.abs(g + res).max()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("shape, mag", [((64, 32), 0.05), ((3, 7, 5), 3.0),
                                        ((128, 1), 1e-4)])
def test_per_tensor_matches_jax(kind, shape, mag):
    """``tensor_scale`` equal as a float (from numpy and from a tensor),
    ``quantize_tensor`` bit for bit, ``dequantize_tensor`` within 1e-7 of
    max |w|."""
    w = _rand(shape, seed=len(shape), scale=mag)
    spec = qz.CompressionSpec(kind)
    jspec = jqz.CompressionSpec(kind)
    scale = qz.tensor_scale(w, spec)
    assert isinstance(scale, float)
    assert scale == jqz.tensor_scale(w, jspec)
    assert qz.tensor_scale(torch.from_numpy(w), spec) == scale
    q = qz.quantize_tensor(w, scale, spec, device=CPU)
    jq = jqz.quantize_tensor(w, scale, jspec)
    assert q.dtype == spec.wire_dtype
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    back = qz.dequantize_tensor(q, scale, torch.float32).numpy()
    jback = np.asarray(jqz.dequantize_tensor(jq, scale, jnp.float32))
    assert np.abs(back - jback).max() <= 1e-7 * np.abs(w).max()


def test_fp8_overflow_gives_the_reference_nan():
    """A caller's own scale can push |w / scale| past 448: the port's
    payload equals the reference's there too (NaN of the value's sign
    above 464 and at +-inf; 448 up to 464), where torch's own cast
    saturates to 448."""
    w = np.concatenate([np.linspace(-600, 600, 4001, dtype=np.float32),
                        np.float32([448.0, 463.99, 464.0, 464.01, -464.01,
                                    465.7, np.inf, -np.inf, 0.0, -0.0])])
    spec = qz.CompressionSpec("fp8")
    q = qz.quantize_tensor(w, 1.0, spec, device=CPU)
    jq = jqz.quantize_tensor(w, 1.0, jqz.CompressionSpec("fp8"))
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    over = np.abs(w) > 464
    assert np.isnan(q.float().numpy()[over]).all()
    assert not np.isnan(q.float().numpy()[~over]).any()
    # torch's own cast would have saturated
    assert not torch.from_numpy(w).to(torch.float8_e4m3fn).float() \
        .isnan().any()


def test_stochastic_rounding_repeats_under_one_seed():
    """One generator seed gives the same payload twice; another seed a
    different one (the draws come from the caller's generator alone)."""
    spec = qz.CompressionSpec("int8", block=16, stochastic=True)
    x = torch.from_numpy(_rand((64, 16), 8))
    a, sa = qz.quantize(x, spec, key=torch.Generator().manual_seed(3))
    b, sb = qz.quantize(x, spec, key=torch.Generator().manual_seed(3))
    c, _ = qz.quantize(x, spec, key=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert not torch.equal(a, c)
    # every stochastic code is one of the two neighbours of the exact y
    y = (x.reshape(-1, 16) / sa[:, None]).numpy()
    q = a.numpy().astype(np.float32)
    assert ((q == np.floor(y)) | (q == np.floor(y) + 1)).all()


def test_stochastic_rounding_unbiased_like_jax():
    """The port's and the reference's stochastic rounding draw from
    different generators, so the payloads differ; both are unbiased over
    many draws of one input, to the same tolerance."""
    spec = qz.CompressionSpec("int8", block=8, stochastic=True)
    jspec = jqz.CompressionSpec("int8", block=8, stochastic=True)
    x = _rand((8,), 9, scale=0.5)
    port, ref = [], []
    for i in range(300):
        p, s = qz.quantize(x, spec, key=torch.Generator().manual_seed(i),
                           device=CPU)
        port.append(qz.dequantize(p, s, x.shape, torch.float32).numpy())
        jp, js = jqz.quantize(jnp.asarray(x), jspec,
                              key=jax.random.PRNGKey(i))
        ref.append(np.asarray(jqz.dequantize(jp, js, x.shape, jnp.float32)))
    step = float(s[0])
    assert np.abs(np.mean(port, axis=0) - x).max() < 0.1 * step
    assert np.abs(np.mean(ref, axis=0) - x).max() < 0.1 * step
