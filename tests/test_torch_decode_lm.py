"""PyTorch port, decoder LM: the port's ``TransformerDecoderLM`` and its
paged decode-mode forwards against the JAX package's, on one set of
weights (the JAX model's, carried across as numpy through
``load_paged_params`` / ``load_numpy_params``).

Every comparison is fp32 on the CPU with atol 1e-5: the frameworks sum
in different orders, nothing else differs.  The port's attention takes
its plain versions here (CPU tensors); the JAX side runs its pure-jax
references, as its own CPU serving path does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import transformer_blocks as jtb
from mxnet_tpu_torch.models import transformer_blocks as ttb

ATOL = 1e-5
VOCAB, UNITS, HIDDEN, LAYERS, HEADS, MAXLEN = 23, 16, 24, 2, 2, 32
PS, POOL = 4, 14                                # page size, pool pages


@pytest.fixture(scope="module", params=[("relu", 1e-5),
                                        ("gelu_tanh", 1e-1)],
                ids=["relu", "gelu_tanh-eps0.1"])
def models(request):
    activation, eps = request.param
    mx.random.seed(11)
    lm = jtb.TransformerDecoderLM(VOCAB, units=UNITS, hidden_size=HIDDEN,
                                  num_layers=LAYERS, num_heads=HEADS,
                                  max_length=MAXLEN, activation=activation,
                                  layer_norm_eps=eps)
    lm.initialize(mx.init.Xavier())
    np_params = jax.tree_util.tree_map(np.asarray, jtb.paged_lm_params(lm))
    port = ttb.TransformerDecoderLM(
        VOCAB, units=UNITS, hidden_size=HIDDEN, num_layers=LAYERS,
        num_heads=HEADS, max_length=MAXLEN, activation=activation,
        layer_norm_eps=eps, device="cpu").load_numpy_params(np_params)
    kw = dict(num_heads=HEADS, page_size=PS, activation=activation,
              layer_norm_eps=eps)
    return lm, port, np_params, kw


def _pools():
    shape = (LAYERS, POOL, PS, HEADS, UNITS // HEADS)
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
            torch.zeros(shape), torch.zeros(shape))


def _close(torch_val, jax_val):
    np.testing.assert_allclose(torch_val.numpy(), np.asarray(jax_val),
                               atol=ATOL)


def _close_pools(tk, tv, jk, jv):
    # page 0 is the null page: padded/inactive writes race there in both
    # frameworks, and nothing ever reads it
    _close(tk[:, 1:], jk[:, 1:])
    _close(tv[:, 1:], jv[:, 1:])


def test_full_forward_matches_jax(models):
    lm, port, _, _ = models
    toks = np.random.RandomState(0).randint(0, VOCAB, (2, 9)).astype(
        np.int32)
    want = lm(nd.NDArray(toks)).asnumpy()
    with torch.no_grad():
        got = port(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_paged_lm_params_roundtrip(models):
    _, port, np_params, _ = models
    got = ttb.paged_lm_params(port)
    ref = ttb.load_paged_params(np_params, device="cpu")
    for key in ("embed", "pos", "fn_g", "fn_b", "proj_w", "proj_b"):
        assert torch.equal(got[key], ref[key]), key
    for a, b in zip(got["cells"], ref["cells"]):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_prefill_decode_verify_match_jax(models):
    """One sequence through prefill, three decode steps (a batch of 2
    with an inactive slot), a width-3 verify tail and a batched verify:
    logits and every written pool page match the JAX forwards."""
    _, _, np_params, kw = models
    tp = ttb.load_paged_params(np_params, device="cpu")
    jk, jv, tk, tv = _pools()
    rs = np.random.RandomState(3)
    prompt = rs.randint(1, VOCAB, 6).astype(np.int32)
    tokens = np.zeros((1, 8), np.int32)             # bucket 8, length 6
    tokens[0, :6] = prompt
    bt = np.asarray([3, 7, 2, 9, 0, 0, 0, 0], np.int32)

    jl, jk, jv = jtb.paged_prefill(np_params, jnp.asarray(tokens),
                                   jnp.int32(6), jnp.asarray(bt), jk, jv,
                                   **kw)
    tl, tk, tv = ttb.paged_prefill(tp, torch.from_numpy(tokens), 6,
                                   torch.from_numpy(bt), tk, tv, **kw)
    _close(tl, jl)
    _close_pools(tk, tv, jk, jv)

    bts = np.stack([bt, np.zeros_like(bt)])         # slot 1 inactive
    for step, pos in enumerate((6, 7, 8)):
        cur = np.asarray([int(np.argmax(np.asarray(jl)) if step == 0
                              else rs.randint(1, VOCAB)), 0], np.int32)
        positions = np.asarray([pos, 0], np.int32)
        jl2, jk, jv = jtb.paged_decode_step(
            np_params, jnp.asarray(cur), jnp.asarray(positions),
            jnp.asarray(bts), jk, jv, **kw)
        tl2, tk, tv = ttb.paged_decode_step(
            tp, torch.from_numpy(cur), torch.from_numpy(positions),
            torch.from_numpy(bts), tk, tv, **kw)
        _close(tl2[0], jl2[0])                      # slot 1 is never read
        _close_pools(tk, tv, jk, jv)

    window = np.zeros((1, 4), np.int32)             # bucket 4, length 3
    window[0, :3] = rs.randint(1, VOCAB, 3)
    jl3, jk, jv = jtb.paged_verify(np_params, jnp.asarray(window),
                                   jnp.int32(9), jnp.int32(3),
                                   jnp.asarray(bt), jk, jv, **kw)
    tl3, tk, tv = ttb.paged_verify(tp, torch.from_numpy(window), 9, 3,
                                   torch.from_numpy(bt), tk, tv, **kw)
    _close(tl3[:3], jl3[:3])
    _close_pools(tk, tv, jk, jv)

    win_b = np.zeros((2, 4), np.int32)
    win_b[0, :2] = rs.randint(1, VOCAB, 2)
    starts = np.asarray([12, 0], np.int32)
    lengths = np.asarray([2, 0], np.int32)          # slot 1 inactive
    jl4, jk, jv = jtb.paged_verify_batch(
        np_params, jnp.asarray(win_b), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(bts), jk, jv, **kw)
    tl4, tk, tv = ttb.paged_verify_batch(
        tp, torch.from_numpy(win_b), torch.from_numpy(starts),
        torch.from_numpy(lengths), torch.from_numpy(bts), tk, tv, **kw)
    _close(tl4[0, :2], jl4[0, :2])
    _close_pools(tk, tv, jk, jv)


def test_paged_path_matches_full_forward(models):
    """Inside the port: prefill + decode logits equal the dense causal
    forward's logits at the same positions."""
    _, port, _, kw = models
    params = ttb.paged_lm_params(port)
    _, _, tk, tv = _pools()
    seq = np.random.RandomState(9).randint(1, VOCAB, 10).astype(np.int32)
    bt = torch.tensor([5, 1, 8, 0, 0, 0, 0, 0], dtype=torch.int32)
    with torch.no_grad():
        full = port(torch.from_numpy(seq[None]))[0]
        tokens = torch.zeros((1, 8), dtype=torch.int32)
        tokens[0, :7] = torch.from_numpy(seq[:7])
        logits, _, _ = ttb.paged_prefill(params, tokens, 7, bt, tk, tv,
                                         **kw)
        np.testing.assert_allclose(logits.numpy(), full[6].numpy(),
                                   atol=ATOL)
        for pos in (7, 8, 9):
            logits, _, _ = ttb.paged_decode_step(
                params, torch.tensor([int(seq[pos])], dtype=torch.int32),
                torch.tensor([pos], dtype=torch.int32), bt[None], tk, tv,
                **kw)
            np.testing.assert_allclose(logits[0].numpy(),
                                       full[pos].numpy(), atol=ATOL)


def test_seeded_init_is_deterministic():
    kw = dict(units=8, hidden_size=16, num_layers=1, num_heads=2,
              max_length=8, device="cpu")
    a = ttb.TransformerDecoderLM(11, generator=torch.Generator()
                                 .manual_seed(5), **kw)
    b = ttb.TransformerDecoderLM(11, generator=torch.Generator()
                                 .manual_seed(5), **kw)
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert torch.all(a.cells[0].attn_norm.gamma == 1)
    assert torch.all(a.proj.bias == 0)
    with pytest.raises(ttb.MXNetError, match="not divisible"):
        ttb.TransformerDecoderLM(11, units=9, num_heads=2, device="cpu")
    with pytest.raises(ttb.MXNetError, match="unsupported activation"):
        ttb.TransformerDecoderLM(11, units=8, num_heads=2,
                                 activation="swish", device="cpu")
