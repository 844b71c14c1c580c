"""PyTorch port, the Gluon models (``mxnet_tpu_torch.models``): BERT with
its heads and the NMT Transformer, against the JAX package's blocks on
the same numpy inputs with the weights carried across by
``save_parameters`` / ``load_parameters``.  The twins of
``tests/test_models.py``'s BERT and Transformer tests, one three-call
step of ``examples/bert_squad.py``'s ``SpanLoss``, a tied-embedding
Transformer, and the Gluon ``BERTModel`` against the ``nn.Module`` form
(``models.torch_bert``) from the same weights.

Tolerances: fp32 outputs within 1e-5 x max|out| (the flash path 1e-4 x
max|out|), losses within 1e-5 relative, gradients within 1e-4 x
max|g|."""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import models as jm
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, models, nd
from mxnet_tpu_torch.models import torch_bert

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

OUT_TOL = 1e-5
FLASH_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# a gradient nought up to rounding: its max|g| at most this much of the
# model's largest |g| (fp32 rounds at 6e-8)
NOUGHT = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _bert_cfg(**kw):
    cfg = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
    cfg.update(kw)
    return cfg


def _carry(jblock, tblock, tmp_path, name="w.params"):
    """The JAX block's weights into the port's block."""
    path = str(tmp_path / name)
    jblock.save_parameters(path)
    tblock.load_parameters(path)
    return path


def _jax_bert(seed=0, head=None, **kw):
    jmx.random.seed(seed)
    bert = jm.get_bert_model("bert_12_768_12", **_bert_cfg(**kw))
    bert.initialize()
    if head is None:
        return bert
    net = head(bert)
    net.initialize()
    return net


def _port(jnet, build, tmp_path):
    net = build()
    _carry(jnet, net, tmp_path)
    return net


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= lim, f"{what}: {err} > {lim}"


def _grads(net):
    return {n: p.grad().asnumpy()
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _bert_inputs(B=2, L=16, valid=(16, 9), seed=3):
    rs = np.random.RandomState(seed)
    inp = rs.randint(0, 64, (B, L)).astype(np.int32)
    tt = (np.arange(L)[None] >= L // 2).astype(np.int32).repeat(B, 0)
    return inp, tt, np.asarray(valid, np.float32)


def _j(*arrays):
    return [jnd.array(a, dtype="int32") if a.dtype == np.int32
            else jnd.array(a) for a in arrays]


def _t(*arrays):
    return [nd.array(a, dtype="int32") if a.dtype == np.int32
            else nd.array(a) for a in arrays]


# -------------------------------------------------------------------- BERT
def test_bert_forward_shapes(tmp_path):
    jbert = _jax_bert()
    tbert = _port(jbert, lambda: models.get_bert_model(
        "bert_12_768_12", **_bert_cfg()), tmp_path)
    assert isinstance(tbert, gluon.HybridBlock)
    arrays = _bert_inputs()
    jseq, jpooled = jbert(*_j(*arrays))
    seq, pooled = tbert(*_t(*arrays))
    assert seq.shape == (2, 16, 32) and pooled.shape == (2, 32)
    _close(seq.asnumpy(), jseq.asnumpy(), OUT_TOL, "seq")
    _close(pooled.asnumpy(), jpooled.asnumpy(), OUT_TOL, "pooled")


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["dense", "flash"])
def test_bert_valid_length_masks_attention(tmp_path, use_flash):
    """Tokens past valid_length do not change the earlier positions, on
    the dense path (the additive mask) and the flash path (the key
    lengths), and both match the JAX model."""
    jbert = _jax_bert(use_flash=use_flash)
    tbert = _port(jbert, lambda: models.get_bert_model(
        "bert_12_768_12", **_bert_cfg(use_flash=use_flash)), tmp_path)
    B, L = 1, 8
    base = np.random.RandomState(4).randint(1, 64, (B, L)).astype(np.int32)
    changed = base.copy()
    changed[0, 5] = (changed[0, 5] + 7) % 64
    tt = np.zeros((B, L), np.int32)
    vl = np.array([4], np.float32)
    tol = FLASH_TOL if use_flash else OUT_TOL
    outs = []
    for toks in (base, changed):
        seq, _ = tbert(*_t(toks, tt, vl))
        jseq, _ = jbert(*_j(toks, tt, vl))
        _close(seq.asnumpy(), jseq.asnumpy(), tol, "seq")
        outs.append(seq.asnumpy()[0, :4])
    _close(outs[1], outs[0], OUT_TOL, "positions before valid_length")


def test_bert_pretrain_heads(tmp_path):
    jhead = _jax_bert(head=lambda b: jm.BERTForPretrain(b, vocab_size=64))

    def build():
        bert = models.get_bert_model("bert_12_768_12", **_bert_cfg())
        return models.BERTForPretrain(bert, vocab_size=64)
    thead = _port(jhead, build, tmp_path)
    inp, tt, _ = _bert_inputs()
    vl = np.full((2,), 16, np.float32)
    mpos = np.random.RandomState(5).randint(0, 16, (2, 3)).astype(np.int32)
    with jag.record():
        jmlm, jnsp = jhead(*_j(inp, tt, vl, mpos))
        jloss = jmlm.sum() + jnsp.sum()
    jloss.backward()
    with autograd.record():
        mlm, nsp = thead(*_t(inp, tt, vl, mpos))
        loss = mlm.sum() + nsp.sum()
    loss.backward()
    assert mlm.shape == (2, 3, 64) and nsp.shape == (2, 2)
    _close(mlm.asnumpy(), jmlm.asnumpy(), OUT_TOL, "mlm")
    _close(nsp.asnumpy(), jnsp.asnumpy(), OUT_TOL, "nsp")
    jg, g = _grads(jhead), _grads(thead)
    assert sorted(g) == sorted(jg)
    for name in jg:
        _close(g[name], jg[name], GRAD_TOL, name)
    assert np.abs(g["bert.word_embed.weight"]).sum() > 0


def test_bert_qa_head(tmp_path):
    jqa = _jax_bert(head=jm.BERTForQA)
    tqa = _port(jqa, lambda: models.BERTForQA(models.get_bert_model(
        "bert_12_768_12", **_bert_cfg())), tmp_path)
    inp, tt, _ = _bert_inputs()
    vl = np.full((2,), 16, np.float32)
    out = tqa(*_t(inp, tt, vl))
    assert out.shape == (2, 16, 2)
    _close(out.asnumpy(), jqa(*_j(inp, tt, vl)).asnumpy(), OUT_TOL, "span")


def test_bert_unknown_config_raises():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="unknown bert config"):
        models.get_bert_model("bert_3_3_3")


def test_gluon_bert_matches_the_module_form(tmp_path):
    """The same JAX weights in the Gluon BERTModel and in
    ``torch_bert.BERTModel`` (``load_numpy_params``): the two port forms
    agree, dense and flash."""
    for use_flash in (False, True):
        jbert = _jax_bert(use_flash=use_flash)
        gbert = _port(jbert, lambda: models.get_bert_model(
            "bert_12_768_12", **_bert_cfg(use_flash=use_flash)), tmp_path)
        tbert = torch_bert.get_bert_model(
            "bert_12_768_12", device="cpu", **_bert_cfg(use_flash=use_flash))
        pre = jbert.prefix
        tbert.load_numpy_params({k[len(pre):]: v.data().asnumpy()
                                 for k, v in jbert.collect_params().items()})
        tbert.eval()
        import torch
        inp, tt, vl = _bert_inputs()
        seq, pooled = gbert(*_t(inp, tt, vl))
        with torch.no_grad():
            tseq, tpooled = tbert(torch.from_numpy(inp),
                                  torch.from_numpy(tt), torch.from_numpy(vl))
        tol = FLASH_TOL if use_flash else OUT_TOL
        _close(seq.asnumpy(), tseq.numpy(), tol, f"seq flash={use_flash}")
        _close(pooled.asnumpy(), tpooled.numpy(), tol,
               f"pooled flash={use_flash}")


def test_span_loss_three_call_step(tmp_path):
    """One record / backward / ``Trainer.step`` of the SQuAD example's
    SpanLoss, hybridized, on the example's own batch: the loss and every
    gradient against the JAX step, each gradient within 1e-4 x its own
    max|g|.  The span loss does not change when one vector is added at
    every position, so the span classifier's bias and the last
    LayerNorm's beta have gradients that are nought up to rounding (JAX
    max|g| 1.9e-7 and 3.4e-9 of the model's largest |g|; the unused
    pooler's are 0): a gradient whose JAX max|g| is at most
    ``NOUGHT`` x the model's largest is held within 1e-4 x that largest
    instead.  The smallest other gradient is 4.8e-4 of it."""
    import bert_squad as ex

    import chip_smoke
    cfg = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
               num_heads=4, max_length=128, dropout=0.0)
    jmx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", **cfg)
    jbert.initialize(jmx.init.Normal(0.02))
    jqa = jm.BERTForQA(jbert)
    jqa.initialize(jmx.init.Normal(0.02))
    tqa = models.BERTForQA(models.get_bert_model("bert_12_768_12", **cfg))
    _carry(jqa, tqa, tmp_path)
    batch = ex.make_batch(np.random.RandomState(0), 4, 64, 8, 48, 4)
    runs = []
    for blk, qa, mod, ag, arrays in (
            (ex.SpanLoss(jqa), jqa, jgluon, jag, batch),
            (chip_smoke._span_loss(mx, tqa), tqa, gluon, autograd,
             _t(*[a.asnumpy() for a in batch]))):
        blk.hybridize(static_alloc=True)
        trainer = mod.Trainer(qa.collect_params(), "adamw",
                              {"learning_rate": 1e-3, "wd": 0.01})
        with ag.record():
            loss = blk(*arrays)
        loss.backward()
        runs.append((float(loss.asnumpy()), _grads(qa)))
        trainer.step(4)
    (jl, jg), (tl, tg) = runs
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert sorted(tg) == sorted(jg)
    scale = max(float(np.abs(g).max()) for g in jg.values())
    nought = []
    for name in jg:
        err = float(np.abs(tg[name] - jg[name]).max())
        own = float(np.abs(jg[name]).max())
        if own <= NOUGHT * scale:
            nought.append(name)
            own = scale
        assert err <= GRAD_TOL * own, (name, err, own)
    assert sorted(nought) == sorted(
        ["span_classifier.bias", "bert.pooler.weight", "bert.pooler.bias",
         "bert.encoder.transformer_cells.1.ffn.layer_norm.beta"]), nought


# ------------------------------------------------------------- Transformer
def _jax_nmt(seed=0, tgt=40, **kw):
    jmx.random.seed(seed)
    cfg = dict(units=16, hidden_size=32, num_layers=2, num_heads=2,
               max_length=64, dropout=0.0)
    cfg.update(kw)
    net = jm.transformer_base(32, tgt, **cfg)
    net.initialize()
    return net


def _port_nmt(jnet, tmp_path, tgt=40, **kw):
    cfg = dict(units=16, hidden_size=32, num_layers=2, num_heads=2,
               max_length=64, dropout=0.0)
    cfg.update(kw)
    return _port(jnet, lambda: models.transformer_base(32, tgt, **cfg),
                 tmp_path)


def _nmt_batch(seed=6, V=40):
    rs = np.random.RandomState(seed)
    return (rs.randint(4, 32, (2, 10)).astype(np.int32),
            rs.randint(4, V, (2, 8)).astype(np.int32),
            np.array([10, 7], np.float32),
            rs.randint(0, V, (2, 8)).astype(np.float32),
            np.array([8, 6], np.float32))


def _nmt_step(ag, net, loss_fn, arrays):
    src, tgt, sv, lab, tv = arrays
    with ag.record():
        logits = net(src, tgt, sv)
        loss = loss_fn(logits, lab, tv)
    loss.backward()
    return logits, loss


def test_transformer_train_and_decode(tmp_path):
    jnet = _jax_nmt()
    tnet = _port_nmt(jnet, tmp_path)
    src, tgt, sv, lab, tv = _nmt_batch()
    jloss_fn = jm.SmoothedSoftmaxCELoss(smoothing=0.1)
    loss_fn = models.SmoothedSoftmaxCELoss(smoothing=0.1)
    jlogits, jloss = _nmt_step(jag, jnet, jloss_fn,
                               [*_j(src, tgt, sv), jnd.array(lab),
                                jnd.array(tv)])
    logits, loss = _nmt_step(autograd, tnet, loss_fn,
                             [*_t(src, tgt, sv), nd.array(lab), nd.array(tv)])
    assert logits.shape == (2, 8, 40)
    _close(logits.asnumpy(), jlogits.asnumpy(), OUT_TOL, "logits")
    _close(loss.asnumpy(), jloss.asnumpy(), LOSS_RTOL, "loss")
    jg, g = _grads(jnet), _grads(tnet)
    assert sorted(g) == sorted(jg)
    for name in jg:
        _close(g[name], jg[name], GRAD_TOL, name)
    # decoding against the JAX package: tests/test_torch_decoding.py
    out = tnet.greedy_decode(*_t(src, sv), max_decode_len=4).asnumpy()
    assert out.shape[0] == 2 and out.shape[1] <= 5
    beam = tnet.beam_search(*_t(src[:1], sv[:1]), beam_size=2,
                            max_decode_len=3).asnumpy()
    assert beam[0, 0] == 2


def test_transformer_causal_mask(tmp_path):
    """A later target token changes no earlier logit, as in the JAX
    model."""
    jnet = _jax_nmt()
    tnet = _port_nmt(jnet, tmp_path)
    rs = np.random.RandomState(7)
    src = rs.randint(4, 32, (1, 6)).astype(np.int32)
    tgt1 = rs.randint(4, 40, (1, 6)).astype(np.int32)
    tgt2 = tgt1.copy()
    tgt2[0, 4] = (tgt2[0, 4] + 3) % 36 + 4
    l1 = tnet(*_t(src, tgt1)).asnumpy()
    l2 = tnet(*_t(src, tgt2)).asnumpy()
    assert np.allclose(l1[0, :4], l2[0, :4], atol=1e-5)
    assert not np.allclose(l1[0, 4:], l2[0, 4:], atol=1e-5)
    _close(l1, jnet(*_j(src, tgt1)).asnumpy(), OUT_TOL, "logits")


def test_label_smoothing_loss_value():
    logits = np.log(np.full((1, 1, 4), 0.25, dtype=np.float32))
    lab = np.array([[1]], dtype=np.float32)
    loss = models.SmoothedSoftmaxCELoss(smoothing=0.1)(
        nd.array(logits), nd.array(lab)).asnumpy()
    jloss = jm.SmoothedSoftmaxCELoss(smoothing=0.1)(
        jnd.array(logits), jnd.array(lab)).asnumpy()
    assert np.allclose(loss, np.log(4), atol=1e-5)
    _close(loss, jloss, LOSS_RTOL, "loss")


def test_transformer_tied_embeddings(tmp_path):
    """``tie_weights=True``: one Parameter for both embeddings, with one
    summed gradient, hybridized, against the JAX model; a Trainer step
    updates it once."""
    jnet = _jax_nmt(tgt=32, tie_weights=True)
    tnet = _port_nmt(jnet, tmp_path, tgt=32, tie_weights=True)
    assert tnet.tgt_embed is tnet.src_embed
    params = tnet.collect_params()
    assert sum(p is tnet.src_embed.weight for p in params.values()) == 1
    src, tgt, sv, lab, tv = _nmt_batch(V=32)
    loss_fn = models.SmoothedSoftmaxCELoss()
    jloss_fn = jm.SmoothedSoftmaxCELoss()
    for net in (tnet, jnet):
        net.hybridize()
    _j_logits, jloss = _nmt_step(jag, jnet, jloss_fn,
                                 [*_j(src, tgt, sv), jnd.array(lab),
                                  jnd.array(tv)])
    _logits, loss = _nmt_step(autograd, tnet, loss_fn,
                              [*_t(src, tgt, sv), nd.array(lab),
                               nd.array(tv)])
    _close(loss.asnumpy(), jloss.asnumpy(), LOSS_RTOL, "loss")
    jg = jnet.src_embed.weight.grad().asnumpy()
    g = tnet.src_embed.weight.grad().asnumpy()
    _close(g, jg, GRAD_TOL, "tied embedding gradient")
    before = tnet.src_embed.weight.data().asnumpy()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    trainer.step(1)
    after = tnet.src_embed.weight.data().asnumpy()
    _close(after, before - 0.5 * g, GRAD_TOL, "one update of the tie")
