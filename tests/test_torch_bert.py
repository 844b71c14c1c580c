"""PyTorch port, BERT and the encoder blocks: the port's ``BERTModel``,
``BERTForPretrain``, ``BERTPretrainLoss`` and ``TransformerEncoderCell``
against the JAX package's, on one set of weights (the JAX model's,
carried across as numpy through ``load_numpy_params``) and the same
numpy batch.  A tiny BERT: vocab 64, units 32, hidden 64, 2 layers, 4
heads, L 24, dropout 0.

Tolerance: fp32 atol 1e-5 (the frameworks sum in different orders;
nothing else differs).  The port's flash path takes the plain versions
of its kernels on CPU tensors; the JAX flash path runs its Pallas
kernels in interpreter mode.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jm
from mxnet_tpu import nd
from mxnet_tpu.models import transformer_blocks as jtb
from mxnet_tpu.models.bert import BERTPretrainLoss as JaxPretrainLoss
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import torch_blocks as ttb

ATOL = 1e-5
KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)
B, L, M = 2, 24, 5
VALID = [24, 11]


def _np_params(block):
    pre = block.prefix
    return {(k[len(pre):] if k.startswith(pre) else k): v.data().asnumpy()
            for k, v in block.collect_params().items()}


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    inputs = rs.randint(0, 64, (B, L)).astype(np.int32)
    types = (np.arange(L)[None] >= 12).astype(np.int32).repeat(B, 0)
    valid = np.asarray(VALID, np.float32)
    positions = np.stack([rs.choice(v, M, replace=False)
                          for v in VALID]).astype(np.int32)
    mlm_y = rs.randint(0, 64, (B, M)).astype(np.int32)
    nsp_y = rs.randint(0, 2, (B,)).astype(np.int32)
    return inputs, types, valid, positions, mlm_y, nsp_y


def _nd(a):
    return nd.array(a, dtype=str(a.dtype))


@pytest.fixture(scope="module", params=[True, False],
                ids=["flash", "dense"])
def pretrain_pair(request):
    use_flash = request.param
    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=use_flash, **KW)
    jbert.initialize()
    jhead = jm.BERTForPretrain(jbert, vocab_size=64)
    jhead.initialize()
    tbert = tm.get_bert_model("bert_12_768_12", use_flash=use_flash,
                              device="cpu", **KW)
    thead = tm.BERTForPretrain(tbert, vocab_size=64)
    thead.load_numpy_params(_np_params(jhead))
    return jhead, thead


def test_bert_model_outputs_match_jax(pretrain_pair):
    jhead, thead = pretrain_pair
    inputs, types, valid, *_ = _batch()
    seq_j, pool_j = jhead.bert(_nd(inputs), _nd(types), _nd(valid))
    with torch.no_grad():
        seq_t, pool_t = thead.bert(*(torch.from_numpy(a)
                                     for a in (inputs, types, valid)))
    np.testing.assert_allclose(seq_t.numpy(), seq_j.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(pool_t.numpy(), pool_j.asnumpy(), atol=ATOL)


def test_pretrain_heads_and_loss_match_jax(pretrain_pair):
    jhead, thead = pretrain_pair
    batch = _batch(2)
    mlm_j, nsp_j = jhead(*(_nd(a) for a in batch[:4]))
    loss_j = JaxPretrainLoss(jhead)(*(_nd(a) for a in batch))
    tb = [torch.from_numpy(a) for a in batch]
    with torch.no_grad():
        mlm_t, nsp_t = thead(*tb[:4])
        loss_t = tm.BERTPretrainLoss(thead)(*tb)
    np.testing.assert_allclose(mlm_t.numpy(), mlm_j.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(nsp_t.numpy(), nsp_j.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j.asnumpy()),
                               rtol=1e-6, atol=ATOL)


def test_bert_model_loads_its_own_names():
    mx.random.seed(3)
    jbert = jm.get_bert_model("bert_12_768_12", **KW)
    jbert.initialize()
    tbert = tm.get_bert_model("bert_12_768_12", device="cpu", **KW)
    tbert.load_numpy_params(_np_params(jbert))
    inputs, types, valid, *_ = _batch()
    seq_j, _ = jbert(_nd(inputs), _nd(types), _nd(valid))
    with torch.no_grad():
        seq_t, _ = tbert(*(torch.from_numpy(a)
                           for a in (inputs, types, valid)))
    np.testing.assert_allclose(seq_t.numpy(), seq_j.asnumpy(), atol=ATOL)


def test_load_numpy_params_rejects_missing_and_misshapen():
    tbert = tm.get_bert_model("bert_12_768_12", device="cpu", **KW)
    names = {k: np.zeros(tuple(p.shape), np.float32)
             for k, p in tbert.gluon_names().items()}
    bad = dict(names)
    del bad["embedding0_weight"]
    with pytest.raises(MXNetError, match="missing"):
        tbert.load_numpy_params(bad)
    bad = dict(names, pooler_weight=np.zeros(3))
    with pytest.raises(MXNetError, match="unknown"):
        tbert.load_numpy_params(bad)
    bad = dict(names, dense0_bias=np.zeros(31, np.float32))
    with pytest.raises(MXNetError, match="shape"):
        tbert.load_numpy_params(bad)


def test_flash_and_dense_ports_agree_with_same_weights():
    """use_flash=True and the dense additive-mask path on one state."""
    dense = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", device="cpu", **KW), vocab_size=64)
    flash = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu", **KW), vocab_size=64)
    flash.load_state_dict(dense.state_dict())
    batch = [torch.from_numpy(a) for a in _batch(4)]
    loss_d = tm.BERTPretrainLoss(dense)(*batch)
    loss_f = tm.BERTPretrainLoss(flash)(*batch)
    gd = torch.autograd.grad(loss_d, list(dense.parameters()))
    gf = torch.autograd.grad(loss_f, list(flash.parameters()))
    np.testing.assert_allclose(float(loss_f.detach()), float(loss_d.detach()),
                               rtol=1e-6)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_weights_come_from_the_generator():
    def make(seed):
        return tm.get_bert_model("bert_12_768_12", device="cpu",
                                 generator=torch.Generator().manual_seed(seed),
                                 **KW)
    a, b, c = make(5), make(5), make(6)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        if n.endswith("weight"):
            assert not torch.equal(pa, pc), n
    emb = a.word_embed.weight.detach()
    assert 0.005 < float(emb.std()) < 0.015          # N(0, 0.01)
    w = a.encoder.transformer_cells[0].attention.qkv.weight.detach()
    assert float(w.abs().max()) <= 0.07 and float(w.std()) > 0.03
    assert torch.all(a.encoder.layer_norm.gamma == 1)
    assert torch.all(a.pooler.bias == 0)


@pytest.mark.parametrize("pre_norm", [False, True],
                         ids=["post-norm", "pre-norm"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_encoder_cell_matches_jax(pre_norm, use_flash):
    mx.random.seed(7)
    jcell = jtb.TransformerEncoderCell(32, 64, 4, 0.0, activation="gelu",
                                       layer_norm_eps=1e-12,
                                       pre_norm=pre_norm,
                                       use_flash=use_flash)
    jcell.initialize()
    tcell = ttb.TransformerEncoderCell(32, 64, 4, 0.0, activation="gelu",
                                       layer_norm_eps=1e-12,
                                       pre_norm=pre_norm,
                                       use_flash=use_flash, device="cpu")
    ttb.load_gluon_params(tcell.gluon_names(), _np_params(jcell), "cell")
    x = np.random.RandomState(8).randn(L, B, 32).astype(np.float32)
    if use_flash:
        valid = np.asarray(VALID, np.float32)
        want = jcell(nd.array(x), None, nd.array(valid)).asnumpy()
        with torch.no_grad():
            got = tcell(torch.from_numpy(x), None, torch.from_numpy(valid))
    else:
        mask = np.where(np.arange(L)[None, :] > np.arange(L)[:, None],
                        -1e9, 0.0).astype(np.float32)
        want = jcell(nd.array(x), nd.array(mask)).asnumpy()
        with torch.no_grad():
            got = tcell(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_positionwise_ffn_matches_jax():
    mx.random.seed(9)
    jffn = jtb.PositionwiseFFN(32, 64, activation="gelu_tanh")
    jffn.initialize()
    tffn = ttb.PositionwiseFFN(32, 64, activation="gelu_tanh", device="cpu")
    ttb.load_gluon_params(tffn.gluon_names(), _np_params(jffn), "ffn")
    x = np.random.RandomState(10).randn(5, 2, 32).astype(np.float32)
    with torch.no_grad():
        got = tffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jffn(nd.array(x)).asnumpy(),
                               atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(units=30, num_heads=4), "not divisible"),
    (dict(units=32, num_heads=4, causal=True), "requires use_flash"),
    (dict(units=32, num_heads=4, window=8), "requires use_flash=True and "
                                            "causal=True"),
    (dict(units=32, num_heads=4, use_flash=True, window=8),
     "requires use_flash=True and causal=True"),
    (dict(units=32, num_heads=4, use_flash=True, causal=True, window=0),
     "window must be >= 1"),
])
def test_self_attention_constructor_errors(kwargs, match):
    with pytest.raises(MXNetError, match=match):
        ttb.MultiHeadSelfAttention(device="cpu", **kwargs)


def test_self_attention_forward_errors():
    flash = ttb.MultiHeadSelfAttention(32, 4, use_flash=True, causal=True,
                                       window=4, device="cpu")
    x = torch.zeros(6, 2, 32)
    with pytest.raises(MXNetError, match="only honored on the flash path"):
        flash(x, torch.zeros(6, 6))
    dense = ttb.MultiHeadSelfAttention(32, 4, device="cpu")
    with pytest.raises(MXNetError, match="valid_length is only consumed"):
        dense(x, None, torch.tensor([6.0, 3.0]))


def test_unknown_bert_config_raises():
    with pytest.raises(MXNetError, match="unknown bert config"):
        tm.get_bert_model("bert_1_2_3", device="cpu")


# ------------------------------------------ the embeddings' weight gradient
@pytest.mark.parametrize("rows", [2, 64])
def test_sorted_segment_embedding_gradient(rows):
    """The word / token-type embeddings' weight gradient (a sorted segment
    sum) equals ``nn.Embedding``'s on the same indices within fp32
    rounding — a 2-row table (every position shares a row, as the
    token-type table) and a 64-row one with rows no index reaches — and
    is the same bits on a second backward."""
    from mxnet_tpu_torch.models.torch_bert import _embed
    torch.manual_seed(0)
    table = torch.nn.Embedding(rows, 16)
    idx = torch.randint(0, min(rows, 40), (6, 50))
    grad = torch.randn(6, 50, 16)
    got = []
    for _ in range(2):
        table.weight.grad = None
        _embed(table, idx).backward(grad)
        got.append(table.weight.grad.clone())
    table.weight.grad = None
    torch.nn.functional.embedding(idx, table.weight).backward(grad)
    want = table.weight.grad
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    if rows > 40:
        assert not got[0][40:].any()


def test_sorted_segment_embedding_keeps_the_table_dtype():
    from mxnet_tpu_torch.models.torch_bert import _embed
    table = torch.nn.Embedding(4, 8).to(torch.bfloat16)
    idx = torch.tensor([[0, 3, 3, 1]])
    out = _embed(table, idx)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert table.weight.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        table.weight.grad.float().sum(1).numpy(), [8, 8, 0, 16])
