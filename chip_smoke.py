#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Drives ``mxnet_tpu_torch`` — paged decode serving of a GPT-2-small-width
``TransformerDecoderLM`` (random fp32 weights from seed 0) — on the
card, through the entry points a user calls.  Phases, each printed as
one JSON line:

1. ``device``  — card name, device count, power limit;
2. ``build``   — compile the two CUDA kernels (``nvcc``, ``sm_90a``);
3. ``kernels`` — each kernel against its plain PyTorch version at the
   slice's shapes, fp32 and bf16, with its time, the plain version's
   time, one PyTorch library call's time and the roofline bound; then
   ``head_dims`` — both kernels at every compiled head dim, small shapes;
4. ``parity``  — ``paged_prefill`` + 32 ``paged_decode_step``s, a
   width-37 ``paged_verify`` and the same window through
   ``paged_verify_batch`` against the dense full forward, and the launch
   counters rising by ``num_layers`` per call;
5. ``serve``   — 8 threads calling ``DecodeEngine.generate`` at once,
   then 4 requests sharing a 256-token prefix (prefix-cache hits run
   the verify kernel); the launch counters are zeroed just before and
   read just after;
6. ``profile`` — one decode step through ``PagedLMAdapter`` at batch 8,
   host-timed, then traced with ``torch.profiler`` (device time by
   kernel family, the costliest kernels, and the device idle share
   against the untraced step time).

Then the kernel summary line, the ``nvidia-smi`` name/power-limit line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises and the script exits non-zero without that line; it never
runs on the CPU.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""
import json
import subprocess
import sys
import threading
import time

import numpy as np

# GPT-2 small (openai-community/gpt2 config.json): n_embd 768, n_head 12,
# n_layer 12, n_inner 4 * 768, vocab 50257, n_positions 1024,
# gelu_new (= gelu_tanh), layer_norm_epsilon 1e-5
GPT2_SMALL = dict(vocab_size=50257, units=768, hidden_size=3072,
                  num_layers=12, num_heads=12, max_length=1024,
                  activation="gelu_tanh", layer_norm_eps=1e-5)
HBM_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=0.0)}
PAGE_SIZE, POOL_PAGES, MAX_BATCH = 16, 513, 8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before
    every launch (outside the timed window), as the decode step finds
    the pool: each layer's pages are cold."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=30, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- kernels
def phase_kernels(torch, dev, timer):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cpu").manual_seed(0)
    B, H, D, P = MAX_BATCH, GPT2_SMALL["num_heads"], 64, 64
    N = B * P + 1
    T = P * PAGE_SIZE
    perm = torch.randperm(N - 1, generator=g)[:B * P] + 1
    bt = perm.reshape(B, P).to(torch.int32).to(dev)
    k32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
    v32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
    ctx = torch.tensor([0, 1, 16, 17, 300, 511, 777, 1024],
                       dtype=torch.int32, device=dev)
    q_dec = torch.randn(B, H, D, generator=g).to(dev)
    verify_cases = {
        1: ([0, 1, 15, 16, 299, 510, 776, 1023],
            [1, 0, 1, 1, 1, 1, 1, 1]),
        5: ([0, 4, 15, 16, 300, 700, 1019, 0], [5, 0, 5, 3, 5, 1, 5, 5]),
        256: ([0, 0, 3, 16, 100, 511, 700, 768],
              [256, 0, 200, 256, 17, 1, 256, 256]),
    }
    q_ver = {W: torch.randn(B, W, H, D, generator=g).to(dev)
             for W in verify_cases}

    def gathered(kp, vp):
        k = kp[bt.long()].reshape(B, T, H, D).transpose(1, 2)
        v = vp[bt.long()].reshape(B, T, H, D).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    report = {}
    # ---- B4: decode attention
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, kp, vp = q_dec.to(dt), k32.to(dt), v32.to(dt)
        got = pa.ragged_paged_attention(q, kp, vp, bt, ctx)
        want = pa.ragged_paged_attention_reference(q, kp, vp, bt, ctx)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
        zero = bool(torch.all(got[0] == 0))        # ctx 0: exact zeros
        check(ok and zero, f"ragged_paged_attention {dtype}: max error "
                           f"{err} (inactive slot zeros: {zero})")
        k_g, v_g = gathered(kp, vp)
        mask = (torch.arange(T, device=dev)[None, :]
                < ctx[:, None])[:, None, None, :]   # (B, 1, 1, T)
        elt = kp.element_size()
        n_tok = int(ctx.clamp(max=T).sum())
        b_moved = (2 * n_tok * H * D + 2 * B * H * D) * elt \
            + bt.numel() * 4 + ctx.numel() * 4
        bound_ms, bound_by = bound(b_moved, 4 * n_tok * H * D, dtype)
        rows.append(dict(
            dtype=dtype, max_abs_err=err,
            ms=timer(lambda: pa.ragged_paged_attention(q, kp, vp, bt, ctx)),
            plain_ms=timer(lambda: pa.ragged_paged_attention_reference(
                q, kp, vp, bt, ctx)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k_g, v_g, attn_mask=mask)),
            bound_ms=bound_ms, bound_by=bound_by))
    report["ragged_paged_attention"] = rows
    # ---- B5: verify attention
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        kp, vp = k32.to(dt), v32.to(dt)
        k_g, v_g = gathered(kp, vp)
        for W, (st_l, ln_l) in verify_cases.items():
            q = q_ver[W].to(dt)
            st = torch.tensor(st_l, dtype=torch.int32, device=dev)
            ln = torch.tensor(ln_l, dtype=torch.int32, device=dev)
            got = pa.ragged_paged_verify(q, kp, vp, bt, st, ln)
            want = pa.ragged_paged_verify_reference(q, kp, vp, bt, st, ln)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
            pad_zero = all(bool(torch.all(got[b, ln_l[b]:] == 0))
                           for b in range(B))
            check(ok and pad_zero,
                  f"ragged_paged_verify {dtype} W={W}: max error {err} "
                  f"(rows past lengths zero: {pad_zero})")
            if W == 1:
                # W = 1 verify is decode attention at ctx = start + 1
                dec = pa.ragged_paged_attention(
                    q[:, 0], kp, vp, bt, torch.where(ln > 0, st + 1, 0))
                werr = float((got[:, 0].float() - dec.float()).abs().max())
                check(werr <= TOL[dtype]["atol"],
                      f"verify W=1 vs decode {dtype}: {werr}")
            rows_pos = st[:, None] + torch.arange(W, device=dev)[None]
            valid = torch.arange(W, device=dev)[None] < ln[:, None]
            mask = ((torch.arange(T, device=dev)[None, None]
                     <= rows_pos[:, :, None]) & valid[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            elt = kp.element_size()
            n_kv = sum(min(s + n, T) for s, n in zip(st_l, ln_l) if n)
            pairs = sum(min(s + w + 1, T) for s, n in zip(st_l, ln_l)
                        for w in range(n))
            b_moved = (2 * n_kv * H * D + 2 * B * W * H * D) * elt \
                + bt.numel() * 4 + 2 * B * 4
            bound_ms, bound_by = bound(b_moved, 4 * pairs * H * D, dtype)
            rows.append(dict(
                dtype=dtype, W=W, max_abs_err=err,
                ms=timer(lambda: pa.ragged_paged_verify(q, kp, vp, bt, st,
                                                        ln)),
                plain_ms=timer(lambda: pa.ragged_paged_verify_reference(
                    q, kp, vp, bt, st, ln)),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    qt, k_g, v_g, attn_mask=mask)),
                bound_ms=bound_ms, bound_by=bound_by))
    report["ragged_paged_verify"] = rows
    emit("kernels", shapes=dict(B=B, H=H, D=D, page_size=PAGE_SIZE,
                                pages_per_seq=P, pool_pages=N,
                                context_lens=ctx.tolist(),
                                verify={W: dict(starts=s, lengths=n)
                                        for W, (s, n) in
                                        verify_cases.items()}),
         results=report)
    return report


def phase_head_dims(torch, dev):
    """Every head dim the kernels are compiled for, fp32 and bf16, at a
    small shape (partial pages, an inactive slot, a multi-page context)
    against the plain versions: the main path only runs head_dim 64."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cpu").manual_seed(3)
    B, H, P = 3, 2, 4
    N = B * P + 1
    bt = (torch.randperm(N - 1, generator=g)[:B * P] + 1).reshape(B, P)
    bt = bt.to(torch.int32).to(dev)
    ctx = torch.tensor([0, 7, 50], dtype=torch.int32, device=dev)
    verify = {1: ([0, 6, 49], [0, 1, 1]), 5: ([0, 3, 40], [5, 0, 5]),
              33: ([0, 1, 30], [33, 12, 0])}
    worst = {}
    for D in pa._HEAD_DIMS:
        k32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
        v32 = torch.randn(N, PAGE_SIZE, H, D, generator=g).to(dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            kp, vp = k32.to(dt), v32.to(dt)
            q = torch.randn(B, H, D, generator=g).to(dev, dt)
            got = pa.ragged_paged_attention(q, kp, vp, bt, ctx)
            want = pa.ragged_paged_attention_reference(q, kp, vp, bt, ctx)
            errs = [float((got.float() - want.float()).abs().max())]
            check(torch.allclose(got.float(), want.float(), **TOL[dtype])
                  and bool(torch.all(got[0] == 0)),
                  f"ragged_paged_attention D={D} {dtype}: {errs[0]}")
            for W, (st_l, ln_l) in verify.items():
                q = torch.randn(B, W, H, D, generator=g).to(dev, dt)
                st = torch.tensor(st_l, dtype=torch.int32, device=dev)
                ln = torch.tensor(ln_l, dtype=torch.int32, device=dev)
                got = pa.ragged_paged_verify(q, kp, vp, bt, st, ln)
                want = pa.ragged_paged_verify_reference(q, kp, vp, bt, st,
                                                        ln)
                errs.append(float((got.float() - want.float()).abs().max()))
                check(torch.allclose(got.float(), want.float(), **TOL[dtype])
                      and all(bool(torch.all(got[b, ln_l[b]:] == 0))
                              for b in range(B)),
                      f"ragged_paged_verify D={D} W={W} {dtype}: "
                      f"{errs[-1]}")
            worst[f"{D}/{dtype}"] = max(errs)
    torch.cuda.synchronize()
    emit("head_dims", head_dims=list(pa._HEAD_DIMS), verify_widths=list(
        verify), max_abs_err=worst)


# ---------------------------------------------------------------- parity
def assert_logits(got, want, where):
    """rtol 1e-3, atol 1e-3 * max|logit|: 12 fp32 layers summed in
    another order than the dense forward."""
    atol = 1e-3 * float(want.abs().max())
    diff = (got - want).abs()
    bad = diff > atol + 1e-3 * want.abs()
    check(not bool(bad.any()),
          f"{where}: logits off by up to {float(diff.max())} "
          f"(atol {atol})")
    return float(diff.max())


def phase_parity(torch, dev, lm):
    from mxnet_tpu_torch.models import transformer_blocks as tb
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving.batcher import next_bucket
    from mxnet_tpu_torch.serving.kv_cache import DeviceKVPool, PageGeometry
    L = lm.num_layers
    kw = dict(num_heads=lm.num_heads, page_size=PAGE_SIZE,
              activation=lm._activation, layer_norm_eps=lm._eps)
    geom = PageGeometry(PAGE_SIZE, POOL_PAGES, lm.max_context, L,
                        lm.num_heads, lm.head_dim)
    pool = DeviceKVPool(geom, device=dev)
    params = tb.paged_lm_params(lm)
    rs = np.random.RandomState(1)
    n_prompt, n_steps, n_tail = 300, 32, 37
    seq = rs.randint(0, lm.vocab_size, n_prompt).tolist()
    bt = torch.zeros(geom.pages_per_seq, dtype=torch.int32, device=dev)
    n_pages = geom.pages_for(n_prompt + n_steps + n_tail)
    bt[:n_pages] = torch.from_numpy(
        rs.permutation(POOL_PAGES - 1)[:n_pages] + 1).to(dev)
    bucket = next_bucket(n_prompt, lm.max_context)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :n_prompt] = torch.tensor(seq, device=dev)
    worst = 0.0
    with torch.no_grad():
        logits, _, _ = tb.paged_prefill(params, tokens, n_prompt, bt,
                                        pool.k_pages, pool.v_pages, **kw)
        step_logits = [logits]
        for i in range(n_steps):
            seq.append(int(torch.argmax(step_logits[-1])))
            before = pa.ragged_paged_attention.launches
            logits, _, _ = tb.paged_decode_step(
                params, torch.tensor([seq[-1]], dtype=torch.int32,
                                     device=dev),
                torch.tensor([n_prompt + i], dtype=torch.int32, device=dev),
                bt[None], pool.k_pages, pool.v_pages, **kw)
            check(pa.ragged_paged_attention.launches - before == L,
                  "decode step did not launch the decode kernel once per "
                  "layer")
            step_logits.append(logits[0])
        start = len(seq)                  # K/V of 0..start-1 is cached
        seq += rs.randint(0, lm.vocab_size, n_tail).tolist()
        before = pa.ragged_paged_verify.launches
        window = torch.tensor([seq[start:]], dtype=torch.int32, device=dev)
        v_logits, _, _ = tb.paged_verify(params, window, start, n_tail, bt,
                                         pool.k_pages, pool.v_pages, **kw)
        check(pa.ragged_paged_verify.launches - before == L,
              "paged_verify did not launch the verify kernel once per "
              "layer")
        # the speculative-decoding shape: the same window re-judged in a
        # batch of 2 beside an inactive slot (its K/V rewrite is
        # idempotent), padded to the next width bucket
        width = next_bucket(n_tail, lm.max_context)
        win_b = torch.zeros((2, width), dtype=torch.int32, device=dev)
        win_b[0, :n_tail] = window[0]
        tables = torch.stack([bt, torch.zeros_like(bt)])
        b_logits, _, _ = tb.paged_verify_batch(
            params, win_b,
            torch.tensor([start, 0], dtype=torch.int32, device=dev),
            torch.tensor([n_tail, 0], dtype=torch.int32, device=dev),
            tables, pool.k_pages, pool.v_pages, **kw)
        full = lm(torch.tensor([seq], device=dev))[0]
        for i, lg in enumerate(step_logits):
            worst = max(worst, assert_logits(lg, full[n_prompt - 1 + i],
                                             f"decode position "
                                             f"{n_prompt - 1 + i}"))
        worst = max(worst, assert_logits(v_logits, full[start:],
                                         "verify tail"))
        worst = max(worst, assert_logits(b_logits[0, :n_tail], full[start:],
                                         "batched verify"))
    emit("parity", prompt_tokens=n_prompt, decode_steps=n_steps,
         verify_width=n_tail, max_abs_logit_diff=worst,
         max_abs_logit=float(full.abs().max()),
         decode_kernel_launches_per_step=L,
         verify_kernel_launches_per_call=L)
    del pool


# ------------------------------------------------------------- profile
def _kernel_us(evt, torch):
    """Device microseconds of one averaged profiler entry if it is a
    device (kernel / memcpy / memset) entry, else None — CPU-op entries
    also carry their kernels' time and would count it twice."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return None
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return None


def phase_profile(torch, dev, lm):
    """Where one decode step's time goes: ``PagedLMAdapter.decode_step``
    (numpy in, numpy out, as the engine calls it) at the serving batch of
    8 over mixed contexts, host-timed, then traced with
    ``torch.profiler`` and its device time split by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving import PagedLMAdapter
    from mxnet_tpu_torch.serving.kv_cache import PageGeometry
    geom = PageGeometry(PAGE_SIZE, POOL_PAGES, lm.max_context,
                        lm.num_layers, lm.num_heads, lm.head_dim)
    adapter = PagedLMAdapter(lm, device=dev)
    adapter.setup(geom)
    positions = np.asarray([377, 280, 179, 450, 112, 92, 230, 64],
                           np.int32)
    tables = np.zeros((MAX_BATCH, geom.pages_per_seq), np.int32)
    nxt = 1
    for b, p in enumerate(positions):
        n = geom.pages_for(int(p) + 1)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    tokens = np.arange(1, MAX_BATCH + 1, dtype=np.int32)

    def step():
        return adapter.decode_step(tokens, positions, tables)

    for _ in range(3):
        step()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        profiled_ms = (time.perf_counter() - t0) / n * 1e3
    split = {"ragged_paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    kernels, top = 0, []
    for evt in prof.key_averages():
        us = _kernel_us(evt, torch)
        if not us:
            continue
        key = evt.key.lower()
        kernels += evt.count
        top.append((us, evt.count, evt.key[:90]))
        if "ragged_paged_attention" in key:
            split["ragged_paged_attention"] += us
        elif "gemm" in key or "cutlass" in key or "sm90_" in key:
            split["gemm"] += us
        else:
            split["other"] += us
    busy_us = sum(split.values())
    adapter.teardown()
    top = [dict(kernel=k, ms_per_step=us / n / 1e3, launches_per_step=c / n)
           for us, c, k in sorted(top, reverse=True)[:8]]
    busy_ms = busy_us / n / 1e3
    # the idle share is taken against the UNPROFILED step: tracing
    # stretches the host's wall time, not the kernels' device time
    emit("profile", batch=MAX_BATCH, positions=positions.tolist(),
         step_ms_host=step_ms, step_ms_host_profiled=profiled_ms,
         device_ms_per_step=busy_ms if busy_us else None,
         device_ms_per_step_by_family={k: v / n / 1e3
                                       for k, v in split.items()}
         if busy_us else None,
         device_idle_share=(1.0 - busy_ms / step_ms) if busy_us else None,
         kernel_launches_per_step=kernels / n if busy_us else None,
         top_kernels=top)


# ----------------------------------------------------------------- serve
def phase_serve(torch, dev, lm):
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import (DecodeEngine, PagedLMAdapter,
                                         ServingConfig)
    cfg = ServingConfig(decode_page_size=PAGE_SIZE,
                        decode_pool_pages=POOL_PAGES,
                        decode_max_batch=MAX_BATCH, prefix_cache=True,
                        decode_max_new_tokens=32)
    eng = DecodeEngine(PagedLMAdapter(lm, device="cuda"), cfg,
                       model_name="gpt2-small", autostart=True)
    rs = np.random.RandomState(2)
    V = lm.vocab_size
    results = []
    try:
        # warm-up: a sub-page prompt (nothing enters the prefix cache)
        eng.generate(rs.randint(0, V, 8), max_new_tokens=4, timeout=600)

        def run_wave(prompts):
            out = [None] * len(prompts)

            def one(i):
                t0 = time.perf_counter()
                first = []
                toks = eng.generate(
                    prompts[i], max_new_tokens=32, timeout=600,
                    on_token=lambda _t: first or first.append(
                        time.perf_counter()))
                out[i] = (prompts[i], toks, first[0] - t0)

            ts = [threading.Thread(target=one, args=(i,), daemon=True)
                  for i in range(len(prompts))]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(900)
            check(not any(t.is_alive() for t in ts), "a request hung")
            check(all(o is not None for o in out), "a request failed")
            return out, time.perf_counter() - t0

        lens = rs.randint(17, 512, MAX_BATCH)
        wave1 = [rs.randint(0, V, n) for n in lens]
        prefix = rs.randint(0, V, 256)
        seed_req = np.concatenate([prefix, rs.randint(0, V, 16)])
        wave3 = [np.concatenate([prefix, rs.randint(0, V, 5)]),
                 np.concatenate([prefix, rs.randint(0, V, 37)]),
                 seed_req]

        pa.ragged_paged_attention.launches = 0
        pa.ragged_paged_verify.launches = 0
        out1, s1 = run_wave(wave1)
        out2, s2 = run_wave([seed_req])
        out3, s3 = run_wave(wave3)
        launches = {"ragged_paged_attention":
                    pa.ragged_paged_attention.launches,
                    "ragged_paged_verify": pa.ragged_paged_verify.launches}
        check(all(launches.values()),
              f"a kernel of the served path never launched: {launches}")
        results = out1 + out2 + out3
        for prompt, toks, _ in results:
            check(len(toks) == 32 and 0 <= int(toks.min())
                  and int(toks.max()) < V,
                  "generate returned a wrong token array")
        st = eng.stats()
        check(st["prefix_hits"] == 3, f"expected 3 prefix hits: {st}")
        check(st["programs"] <= st["program_bound"],
              f"programs {st['programs']} > bound {st['program_bound']}")
    finally:
        stopped = eng.stop(timeout=120)
    check(stopped, "engine did not stop")
    check(eng.allocator.used_pages == 0,
          f"{eng.allocator.used_pages} pages still held after drain")
    eng.allocator.check_leaks()
    # greedy tokens vs the dense forward's argmax (reported: random
    # weights make near-ties, so a flip is not a failure)
    agree = total = 0
    with torch.no_grad():
        for prompt, toks, _ in results:
            seq = np.concatenate([prompt, toks[:-1]]).astype(np.int64)
            full = lm(torch.from_numpy(seq)[None].to(dev))[0]
            ref = full[len(prompt) - 1:].argmax(-1).cpu().numpy()
            agree += int((ref == toks).sum())
            total += len(toks)
    ttft = sorted(r[2] for r in results)
    gen = sum(len(r[1]) for r in results)
    emit("serve", requests=len(results), generated_tokens=gen,
         wall_s=s1 + s2 + s3,
         tokens_per_s=gen / (s1 + s2 + s3),
         wave_tokens_per_s=[len(out1) * 32 / s1, 32 / s2,
                            len(out3) * 32 / s3],
         ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
         prompt_lens=[len(r[0]) for r in results],
         prefix_hits=st["prefix_hits"], prefix_misses=st["prefix_misses"],
         prefix_tokens_saved=st["prefix_tokens_saved"],
         programs=st["programs"], program_bound=st["program_bound"],
         used_pages_after_drain=eng.allocator.used_pages,
         kernel_launches=launches,
         greedy_vs_full_forward_argmax=agree / total)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.models import TransformerDecoderLM
    from mxnet_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: dict(seconds=b["seconds"],
                          ptxas=[ln.strip() for ln in b["ptxas"].splitlines()
                                 if "registers" in ln or "spill" in ln])
                  for n, b in built.items()})

    report = phase_kernels(torch, dev, Timer(torch, dev))
    phase_head_dims(torch, dev)
    lm = TransformerDecoderLM(**GPT2_SMALL, device=dev,
                              generator=torch.Generator().manual_seed(0))
    lm.eval()
    phase_parity(torch, dev, lm)
    launches = phase_serve(torch, dev, lm)
    # last: the profiler's device tracing slows every later launch
    phase_profile(torch, dev, lm)

    sources = {"ragged_paged_attention": ("mxnet_tpu/ops/pallas_kernels.py"
                                          ":586"),
               "ragged_paged_verify": "mxnet_tpu/ops/pallas_kernels.py:751"}
    kernels = []
    for name, replaces in sources.items():
        rows = [r for r in report[name] if r["dtype"] == "float32"]
        main_row = max(rows, key=lambda r: r.get("W", 0))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"mxnet_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
