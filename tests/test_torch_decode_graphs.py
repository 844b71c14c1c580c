"""PyTorch port, the decode path's compiled-program tier on the CPU.

- ``paged_prefill`` / ``paged_verify`` take ``length`` / ``start`` as
  0-d or 1-element device tensors (what a CUDA graph captures: one
  program for every value) and give the int form's logits bit for bit,
  and the JAX package's within atol 1e-5 (fp32; the frameworks sum in
  other orders, as in tests/test_torch_decode_lm.py).
- ``PagedLMAdapter``'s per-signature programs (``graphs=True``: static
  input buffers, one staging copy; on the CPU the forward is called on
  them, on the card a CUDA graph replays over them) give the same
  logits and pools as direct calls (``graphs=False``) over consecutive
  calls with other inputs, so no stale static row survives a call.
- ``refresh()`` copies new weights into the captured tensors in place
  and then serves a fresh adapter's logits; ``programs()`` and
  ``compiled`` count as on the card.
- ``DecodeEngine.signatures()`` (what the engine hands the adapter's
  ``warm()`` when it binds it, so graphs are captured before the first
  request) lists every signature the engine then calls, target and
  draft, and with the COW copies counts ``program_bound``; the inputs
  a signature is built on write K/V only into the null page 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import transformer_blocks as jtb
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer_blocks as ttb
from mxnet_tpu_torch.serving import ServingConfig
from mxnet_tpu_torch.serving.decode import (DecodeEngine, PagedLMAdapter,
                                            _param_items, _warm_args)
from mxnet_tpu_torch.serving.kv_cache import PageGeometry

ATOL = 1e-5
VOCAB, UNITS, HIDDEN, LAYERS, HEADS, MAXLEN = 23, 16, 24, 2, 2, 32
PS, POOL = 4, 17                                # page size, pool pages
KW = dict(num_heads=HEADS, page_size=PS, activation="gelu_tanh",
          layer_norm_eps=1e-5)


@pytest.fixture(scope="module")
def models():
    mx.random.seed(5)
    lm = jtb.TransformerDecoderLM(VOCAB, units=UNITS, hidden_size=HIDDEN,
                                  num_layers=LAYERS, num_heads=HEADS,
                                  max_length=MAXLEN, activation="gelu_tanh")
    lm.initialize(mx.init.Xavier())
    np_params = jax.tree_util.tree_map(np.asarray, jtb.paged_lm_params(lm))
    return np_params


def _port_lm(np_params):
    return ttb.TransformerDecoderLM(
        VOCAB, units=UNITS, hidden_size=HIDDEN, num_layers=LAYERS,
        num_heads=HEADS, max_length=MAXLEN, activation="gelu_tanh",
        device="cpu").load_numpy_params(np_params)


def _pools():
    shape = (LAYERS, POOL, PS, HEADS, UNITS // HEADS)
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
            torch.zeros(shape), torch.zeros(shape))


@pytest.mark.parametrize("form", ["0-d", "1-element"])
def test_tensor_scalars_match_int_form_and_jax(models, form):
    np_params = models
    tp = ttb.load_paged_params(np_params, device="cpu")
    rs = np.random.RandomState(4)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :6] = rs.randint(1, VOCAB, 6)
    bt = np.asarray([3, 7, 2, 9, 0, 0, 0, 0], np.int32)
    window = np.zeros((1, 4), np.int32)
    window[0, :3] = rs.randint(1, VOCAB, 3)

    def scalar(v):
        t = torch.tensor(v, dtype=torch.int32)
        return t if form == "0-d" else t.reshape(1)

    jk, jv, ik, iv = _pools()
    tk, tv = ik.clone(), iv.clone()
    jl, jk, jv = jtb.paged_prefill(np_params, jnp.asarray(tokens),
                                   jnp.int32(6), jnp.asarray(bt), jk, jv,
                                   **KW)
    il, ik, iv = ttb.paged_prefill(tp, torch.from_numpy(tokens), 6,
                                   torch.from_numpy(bt), ik, iv, **KW)
    tl, tk, tv = ttb.paged_prefill(tp, torch.from_numpy(tokens), scalar(6),
                                   torch.from_numpy(bt), tk, tv, **KW)
    assert torch.equal(tl, il)
    assert torch.equal(tk, ik) and torch.equal(tv, iv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    jl3, jk, jv = jtb.paged_verify(np_params, jnp.asarray(window),
                                   jnp.int32(6), jnp.int32(3),
                                   jnp.asarray(bt), jk, jv, **KW)
    il3, ik, iv = ttb.paged_verify(tp, torch.from_numpy(window), 6, 3,
                                   torch.from_numpy(bt), ik, iv, **KW)
    tl3, tk, tv = ttb.paged_verify(tp, torch.from_numpy(window), scalar(6),
                                   scalar(3), torch.from_numpy(bt), tk, tv,
                                   **KW)
    assert torch.equal(tl3, il3)
    assert torch.equal(tk, ik) and torch.equal(tv, iv)
    np.testing.assert_allclose(tl3[:3].numpy(), np.asarray(jl3)[:3],
                               atol=ATOL)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               atol=ATOL)


def _adapter(lm, graphs):
    a = PagedLMAdapter(lm, device="cpu", graphs=graphs)
    a.setup(PageGeometry(PS, POOL, MAXLEN, LAYERS, HEADS, UNITS // HEADS))
    return a


def _calls(rs):
    """Three calls of each family with other inputs each time (shorter
    lengths after longer ones, other tables), in the engine's dtypes."""
    P = MAXLEN // PS
    out = []
    for length, start in ((7, 9), (3, 4), (5, 13)):
        tokens = np.zeros((1, 8), np.int32)
        tokens[0, :length] = rs.randint(1, VOCAB, length)
        bt = np.zeros(P, np.int32)
        bt[:5] = rs.permutation(np.arange(1, POOL))[:5]
        out.append(("prefill", (tokens, np.int32(length), bt)))
        dec_tok = rs.randint(1, VOCAB, 2).astype(np.int32)
        dec_pos = np.asarray([length, 0], np.int32)     # slot 1 inactive
        dec_bt = np.stack([bt, np.zeros_like(bt)])
        out.append(("decode_step", (dec_tok, dec_pos, dec_bt)))
        win = np.zeros((1, 4), np.int32)
        n = 4 - length % 2
        win[0, :n] = rs.randint(1, VOCAB, n)
        out.append(("verify", (win, np.int32(start), np.int32(n), bt)))
        wb = np.zeros((2, 4), np.int32)
        wb[0, :2] = rs.randint(1, VOCAB, 2)
        out.append(("verify_batch",
                    (wb, np.asarray([start + 4, 0], np.int32),
                     np.asarray([2, 0], np.int32), dec_bt)))
    return out


def test_programs_equal_direct_calls_over_consecutive_inputs(models):
    lm = _port_lm(models)
    prog, direct = _adapter(lm, True), _adapter(lm, False)
    for family, args in _calls(np.random.RandomState(8)):
        got = getattr(prog, family)(*args)
        want = getattr(direct, family)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=family)
        assert torch.equal(prog.pool.k_pages, direct.pool.k_pages)
        assert torch.equal(prog.pool.v_pages, direct.pool.v_pages)
    assert set(prog._programs) == prog._signatures


def test_refresh_copies_in_place_and_serves_new_weights(models):
    lm = _port_lm(models)
    adapter = _adapter(lm, True)
    _, args = _calls(np.random.RandomState(9))[0]
    before = adapter.prefill(*args)
    ptrs = {k: t.data_ptr() for k, t in _param_items(adapter.params)}
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        # new storage for every weight: the adapter's tensors are stale
        for p in lm.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.2
    adapter.refresh()
    assert {k: t.data_ptr() for k, t in
            _param_items(adapter.params)} == ptrs
    got = adapter.prefill(*args)
    np.testing.assert_array_equal(got, _adapter(lm, True).prefill(*args))
    assert not np.allclose(got, before)
    assert adapter.compiled == 1                # the program survived
    with torch.no_grad():
        lm.proj.bias.data = torch.zeros(VOCAB + 1)
    with pytest.raises(MXNetError, match="shapes"):
        adapter.refresh()


def test_programs_and_compiled_counted_as_on_the_card(models):
    lm = _port_lm(models)
    graphs, eager = _adapter(lm, True), _adapter(lm, False)
    calls = _calls(np.random.RandomState(10))
    for i, (family, args) in enumerate(calls):
        getattr(graphs, family)(*args)
        getattr(eager, family)(*args)
        # one program built per new signature, none on a repeat
        assert graphs.compiled == graphs.programs() == min(i + 1, 4)
    assert graphs.compiled == graphs.programs() == 4
    assert graphs.disk_hits == 0
    assert eager.programs() == 4 and eager.compiled == 0
    graphs.copy_page(2, 3)                      # eager, one signature
    assert graphs.programs() == 5 and graphs.compiled == 4
    graphs.teardown()
    assert graphs._programs == {}
    graphs.setup(PageGeometry(PS, POOL, MAXLEN, LAYERS, HEADS,
                              UNITS // HEADS))
    family, args = calls[1]
    getattr(graphs, family)(*args)              # built again after setup
    assert graphs.compiled == 5 and graphs.programs() == 5


ENGINES = {"plain": {}, "prefix": dict(prefix_cache=True),
           "spec": dict(spec_k=2),
           "spec_prefix": dict(spec_k=2, prefix_cache=True)}


def _engine(lm, draft=None, adapter=PagedLMAdapter, **kw):
    cfg = ServingConfig(decode_page_size=PS, decode_pool_pages=POOL,
                        decode_max_batch=2, decode_max_new_tokens=4, **kw)
    return DecodeEngine(adapter(lm, device="cpu"), cfg, model_name="lm",
                        draft=None if draft is None
                        else adapter(draft, device="cpu"))


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_signatures_cover_its_calls_within_the_bound(models, case):
    kw = ENGINES[case]
    spec = "spec_k" in kw
    eng = _engine(_port_lm(models), _port_lm(models) if spec else None,
                  **kw)
    eng.start()
    try:
        prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        for p in (prompt, prompt, prompt[:5] + [9, 9], [3]):
            assert len(eng.generate(p, max_new_tokens=4,
                                    timeout=300)) == 4
    finally:
        assert eng.stop(timeout=60)
    target = set(eng.signatures())
    assert len(target) == len(eng.signatures())
    assert eng.model._signatures - {("cow",)} <= target
    n = len(target)
    if spec:
        draft = set(eng.signatures(draft=True))
        assert eng.draft._signatures - {("cow",)} <= draft
        assert ("verify_batch", 2, 4) in eng.model._signatures
        n += len(draft)
    if "prefix_cache" in kw:
        assert ("cow",) in eng.model._signatures
        assert eng.stats()["prefix_hits"] >= 1
        n += 1 + spec                   # one COW program per model
    assert n <= eng.program_bound
    if not spec or "prefix_cache" in kw:
        # the bound also counts a draft's verify family, which only
        # prefix hits call: exact wherever that family is used
        assert n == eng.program_bound


def test_engine_hands_its_signatures_to_warm_on_every_bind(models):
    class Recording(PagedLMAdapter):
        def warm(self, signatures):
            self.warmed = getattr(self, "warmed", []) + [list(signatures)]
            super().warm(signatures)

    eng = _engine(_port_lm(models), _port_lm(models), adapter=Recording,
                  spec_k=2, prefix_cache=True)
    want = [eng.signatures()]
    assert eng.model.warmed == want
    assert eng.draft.warmed == [eng.signatures(draft=True)]
    # the CPU has no graphs: nothing is built ahead
    assert eng.model.compiled == eng.model.programs() == 0
    eng.start()
    assert eng.stop(timeout=60)
    eng.start()                         # a restart binds (and warms) again
    assert eng.stop(timeout=60)
    assert eng.model.warmed == want * 2
    assert len(eng.draft.warmed) == 2


@pytest.mark.parametrize("family", ["prefill", "decode", "verify",
                                    "verify_batch"])
def test_warm_inputs_write_only_the_null_page(models, family):
    eng = _engine(_port_lm(models), _port_lm(models), spec_k=2,
                  prefix_cache=True)
    adapter = eng.model
    P = eng.geometry.pages_per_seq
    keys = [k for k in eng.signatures() if k[0] == family]
    assert keys
    method = "decode_step" if family == "decode" else family
    for key in keys:
        out = getattr(adapter, method)(*_warm_args(key, P))
        assert np.isfinite(out).all()
        assert adapter._signatures >= {key}
    for pages in (adapter.pool.k_pages, adapter.pool.v_pages):
        assert pages[:, 0].abs().sum() > 0
        assert not pages[:, 1:].any()
