"""PyTorch port, the Transformer's beam search
(``mxnet_tpu_torch.models.decoding``): the twins of
``tests/test_decoding.py`` on the weights of the JAX package's model
(carried by ``save_parameters`` / ``load_parameters``), and the port's
search against the JAX package's compiled search, token for token.  On
the CPU the decode step runs eagerly, through the same host loop as the
card's graph replays."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jm
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, nd
from mxnet_tpu_torch.base import KernelError, MXNetError
from mxnet_tpu_torch.models import decoding

CFG = dict(units=32, hidden_size=64, num_layers=2, num_heads=4, dropout=0.0,
           max_length=64)
# an EOS that this model's first steps do not propose at once (with the
# default 3 every beam ends at its first token), so the searches below
# rank and finish beams at different steps
EOS = 31


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX reference model and the port's, with the same weights."""
    jmx.random.seed(0)
    jmod = jm.transformer_base(src_vocab_size=32, **CFG)
    jmod.initialize(jmx.init.Xavier())
    path = str(tmp_path_factory.mktemp("decoding") / "nmt.params")
    jmod.save_parameters(path)
    with mx.cpu(0):
        tmod = models.transformer_base(src_vocab_size=32, **CFG)
        tmod.load_parameters(path)
    return jmod, tmod


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _src(seed, shape):
    return np.random.RandomState(seed).randint(4, 32, shape).astype(np.int32)


def _t(a):
    return nd.array(a, dtype="int32") if a.dtype == np.int32 \
        else nd.array(a)


def test_compiled_matches_host_oracle(pair):
    _jmod, m = pair
    src = _t(_src(0, (3, 7)))
    sv = _t(np.array([7, 5, 7], np.float32))
    out_c = m.beam_search(src, sv, beam_size=4, max_decode_len=10) \
        .asnumpy()
    out_h = m.beam_search_host(src, sv, beam_size=4,
                               max_decode_len=10).asnumpy()
    for b in range(3):
        n = out_h[b].shape[0]
        assert list(out_c[b][:n]) == list(out_h[b][:n]), b


def test_beam1_matches_greedy(pair):
    _jmod, m = pair
    src = _t(_src(1, (2, 6)))
    sv = _t(np.array([6, 6], np.float32))
    g = m.greedy_decode(src, sv, max_decode_len=8).asnumpy()
    b1 = m.beam_search(src, sv, beam_size=1, max_decode_len=8).asnumpy()
    for b in range(2):
        n = g[b].shape[0]
        assert list(b1[b][:n]) == list(g[b][:n]), b


def test_program_cache_and_refresh(tmp_path):
    """One program a signature; a parameter value replaced since (here
    ``set_data``) is copied into the tensor the program reads, at
    ``refresh()`` or at the next search, and the program survives."""
    mx.random.seed(3)
    m = models.transformer_base(src_vocab_size=32, **CFG)
    m.initialize(mx.init.Xavier())
    src = _t(_src(2, (2, 5)))
    m.beam_search(src, beam_size=2, max_decode_len=6)
    dec = m._beam_decoder
    n_progs = len(dec._progs)
    m.beam_search(src, beam_size=2, max_decode_len=6)
    assert len(dec._progs) == n_progs
    before = m.beam_search(src, beam_size=2, max_decode_len=6).asnumpy()
    read = dec.params["proj_w"]
    p = m.proj.weight
    p.set_data(p.data() * 1.5)
    assert p.data()._data is not read
    dec.refresh()
    assert len(dec._progs) == n_progs
    assert dec.params["proj_w"] is read
    np.testing.assert_array_equal(read.detach().numpy(), p.data().asnumpy())
    after = m.beam_search(src, beam_size=2, max_decode_len=6).asnumpy()
    assert before.shape == after.shape
    assert len(dec._progs) == n_progs


def test_max_decode_len_beyond_pos_table_raises(pair):
    _jmod, m = pair
    src = _t(np.array([[5, 6, 7]], np.int32))
    out = m.beam_search(src, beam_size=2, max_decode_len=64)
    assert out.shape == (1, 65)
    with pytest.raises(MXNetError, match="positional"):
        m.beam_search(src, beam_size=2, max_decode_len=65)


@pytest.mark.parametrize("beam,max_len,alpha", [(4, 10, 0.6), (2, 12, 1.0),
                                                (1, 8, 0.6)])
def test_matches_the_jax_compiled_search(pair, beam, max_len, alpha):
    jmod, m = pair
    src = _src(10 + beam, (3, 7))
    sv = np.array([7, 4, 6], np.float32)
    want = jmod.beam_search(jnd.array(src, dtype="int32"), jnd.array(sv),
                            eos=EOS, beam_size=beam, max_decode_len=max_len,
                            alpha=alpha).asnumpy()
    got = m.beam_search(_t(src), _t(sv), eos=EOS, beam_size=beam,
                        max_decode_len=max_len, alpha=alpha).asnumpy()
    assert got.dtype == np.int32
    assert len(set(got[:, 1:].ravel().tolist())) > 2, got
    np.testing.assert_array_equal(got, want)


def test_steps_after_the_last_beam_finishes_change_nothing(monkeypatch):
    """A check of ``finished`` after every step, after every 4 (the
    default) and never give the same tokens: the steps past the
    reference's early exit are no-ops.  EOS gets a large output bias, so
    every beam finishes within a few steps.  Syncs: one a 4 steps short
    of max_len, and the result's read."""
    mx.random.seed(4)
    m = models.transformer_base(src_vocab_size=32, **CFG)
    m.initialize(mx.init.Xavier())
    bias = np.zeros(32, np.float32)
    bias[EOS] = 2.5
    m.proj.bias.set_data(nd.array(bias))
    src, sv = _t(_src(5, (2, 7))), _t(np.array([7, 3], np.float32))
    outs, steps = {}, {}
    for every in (1, decoding.CHECK_EVERY, 10 ** 6):
        monkeypatch.setattr(decoding, "CHECK_EVERY", every)
        outs[every] = m.beam_search(src, sv, eos=EOS, beam_size=3,
                                    max_decode_len=12).asnumpy()
        last = m._beam_decoder.last
        assert last["replays"] == 0 and last["eager_steps"] == last["steps"]
        steps[every] = last["steps"]
    assert steps[1] < steps[4] < steps[10 ** 6] == 12, steps
    assert (outs[4][:, 1:] != EOS).any(), outs[4]
    np.testing.assert_array_equal(outs[1], outs[4])
    np.testing.assert_array_equal(outs[10 ** 6], outs[4])
    assert m._beam_decoder.last["syncs"] == 1


def test_failed_capture_poisons_the_signature(pair):
    """A step that cannot be captured raises KernelError, and so does
    every later search of the signature: nothing runs it another way."""
    _jmod, m = pair
    dec = decoding.TransformerBeamDecoder(m)
    src = _t(_src(6, (1, 4)))
    dec(src, beam_size=2, max_decode_len=5)
    prog = next(iter(dec._progs.values()))
    prog.use_graph, prog.graph = True, None     # the CPU has no graphs
    with pytest.raises(KernelError, match="capture"):
        dec(src, beam_size=2, max_decode_len=5)
    with pytest.raises(KernelError, match="capture"):
        dec(src, beam_size=2, max_decode_len=5)


def test_a_bfloat16_model_decodes_in_float32(pair):
    """The step reads float32 copies of a bf16 model's parameters, made
    at every search: the tokens of a float32 model holding the same
    (bf16-rounded) values.  No source lengths: the float32 padding mask
    does not mix with a bf16 encoder's scores."""
    _jmod, m = pair
    src, sv = _t(_src(8, (2, 6))), None
    rounded = models.transformer_base(src_vocab_size=32, **CFG)
    low = models.transformer_base(src_vocab_size=32, **CFG)
    for net in (rounded, low):
        net.initialize()
        for (name, p), q in zip(net._collect_params_with_prefix().items(),
                                m._collect_params_with_prefix().values()):
            p.set_data(q.data().astype("bfloat16").astype("float32"))
    low.cast("bfloat16")
    kw = dict(eos=EOS, beam_size=3, max_decode_len=8)
    want = rounded.beam_search(src, sv, **kw).asnumpy()
    got = low.beam_search(src, sv, **kw).asnumpy()
    assert low.proj.weight.data().data_torch.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)
