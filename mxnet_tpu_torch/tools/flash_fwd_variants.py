#!/usr/bin/env python3
"""Build variants of the fp32 flash-attention forward kernel (B1) side
by side on one card, hold each against the plain version and fp64, and
time them in turns.

The forward's counterpart of ``flash_bwd_variants.py``, whose
``build_variants`` it uses: a variant is a list of text patches ``[file,
old, new]`` applied to a copy of ``mxnet_tpu_torch/csrc``
(``flash_fwd_variants.json`` beside this script holds the variants that
``PERF.md`` reports); ``"kept"`` has none and is the committed kernel;
an ``ablate_`` variant leaves a part out and gives wrong results on
purpose (its time says what that part costs). At ``chip_smoke.py``'s
``_flash_cases`` inputs (same seed and order), each variant's O and LSE
are held against the plain version (O as a share of max|O|, LSE
absolute, as ``flash_kernels``) and against fp64, and at the timed
shapes each variant is timed with ``chip_smoke.Timer`` in order and then
in reverse order, beside ``scaled_dot_product_attention``. One JSON line
per result; the card's name and power limit come first.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/flash_fwd_variants.py [specs.json]``
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CHECKED = ("train_batch", "lengths_0_1_37_512", "causal", "head_dim_128",
           "head_dim_16", "head_dim_32", "flash2048")
TIMED = ("train_batch", "causal", "head_dim_128", "head_dim_16",
         "head_dim_32", "flash2048")
SOURCE = "flash_attention_fwd"


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as cs
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import flash_attention as fa
    from flash_bwd_variants import build_variants  # this directory
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "flash_fwd_variants.json")
    with open(spec_path) as fh:
        specs = json.load(fh)
    print(json.dumps({"device": cs.nvidia_smi(), "torch": torch.__version__}))
    entries = build_variants(build, cs, specs, (SOURCE,),
                             "flash_fwd_variants")
    dev = torch.device("cuda:0")
    timer = cs.Timer(torch, dev)

    def launch(name, q, k, v, ln, causal, sc, window):
        BH, Lq, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((BH, Lq, 1), dtype=torch.float32, device=dev)
        rc = entries[name, SOURCE](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(),
            out.data_ptr(), lse.data_ptr(), BH, Lq, k.shape[1], D,
            float(sc), int(causal), int(window), 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {name}: launch error {rc}")
        return out, lse

    g = torch.Generator().manual_seed(5)
    for label, BH, Lq, Lk, D, causal, window, lens in cs._flash_cases():
        # draw every case's inputs, as flash_kernels does, so that the
        # checked cases see the same tensors
        q, k, v, _ = (torch.randn(BH, L, D, generator=g)
                      for L in (Lq, Lk, Lk, Lq))
        if label not in CHECKED:
            continue
        q, k, v = (t.to(dev) for t in (q, k, v))
        ln = torch.tensor(lens if lens is not None else [Lk] * BH,
                          dtype=torch.int32, device=dev)
        sc = 1.0 / D ** 0.5
        args = (q, k, v, ln, causal, sc, window)
        plain = fa.flash_attention_fwd_reference(q, k, v, ln, causal, sc,
                                                 window)
        mask = fa._visible(Lq, Lk, ln, causal, window, dev)
        s = torch.where(mask, q.double() @ k.double().transpose(1, 2) * sc,
                        -1e30)
        m = s.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        safe = torch.where(l == 0, 1.0, l)
        # rows that see no key: LSE is fp32's -1e30 on every side
        exact = (p @ v.double() / safe,
                 torch.where(l == 0, float(torch.tensor(-1e30)),
                             m + torch.log(safe)))
        del s, p, mask

        def errs(got, want):
            return dict(out=cs._rel_err(got[0], want[0]),
                        lse=float((got[1].double() - want[1]).abs().max()))
        print(json.dumps({"shape": label, "variant": "plain",
                          "err_vs_fp64": errs(plain, exact)}))
        for name in specs:
            got = launch(name, *args)
            again = launch(name, *args)
            torch.cuda.synchronize()
            print(json.dumps({
                "shape": label, "variant": name, "err": errs(got, plain),
                "err_vs_fp64": errs(got, exact),
                "repeats": all(map(torch.equal, got, again))}), flush=True)
        if label in TIMED:
            vis = fa._visible(Lq, Lk, ln, causal, window, dev).expand(
                BH, Lq, Lk)[None]
            sdpa = timer(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=vis))
            for order in (list(specs), list(specs)[::-1]):
                for name in order:
                    print(json.dumps({"shape": label, "variant": name,
                                      "ms": timer(lambda: launch(name,
                                                                 *args)),
                                      "sdpa_ms": sdpa}), flush=True)
        del plain, exact
    return 0


if __name__ == "__main__":
    sys.exit(main())
