#!/usr/bin/env python3
"""Build variants of the fp32 flash-attention backward kernels (B2, B3)
side by side on one card, hold each against the plain versions and fp64,
and time them in turns.

A variant is a list of text patches ``[file, old, new]`` applied to a
copy of ``mxnet_tpu_torch/csrc`` (``flash_bwd_variants.json`` beside this
script holds the variants that ``PERF.md`` reports); ``"kept"`` has none
and is the committed kernel.  Every variant's two libraries are compiled
at once with the flags of ``ops/build.py`` into
``build/flash_bwd_variants/<name>/``.  Then, at ``chip_smoke.py``'s
``_flash_cases`` inputs (same seed and order), each variant's dQ, dK and
dV are held against the plain versions (``rel_err``, as
``flash_kernels``) and against fp64 from the same LSE and Delta, and
at the timed shapes each variant's B2 and B3 are timed with
``chip_smoke.Timer`` in order and then in reverse order.  One JSON line
per result; the card's name and power limit come first.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/flash_bwd_variants.py [specs.json]``
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CHECKED = ("train_batch", "lengths_0_1_37_512", "causal", "head_dim_128",
           "flash2048")
TIMED = ("train_batch", "causal", "head_dim_128")
SOURCES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def build_variants(build, chip_smoke, specs, sources=SOURCES,
                   subdir="flash_bwd_variants"):
    """{(variant, source): ctypes entry point}, after printing each
    variant's fp32 kernels' ptxas registers and spills; the copies go to
    ``build/<subdir>/<variant>/``."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    procs = []
    for name, patches in specs.items():
        d = os.path.join(ROOT, "build", subdir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in patches:
            path = os.path.join(d, fname)
            with open(path) as fh:
                text = fh.read()
            if old not in text:
                raise SystemExit(f"variant {name}: {fname} lacks {old!r}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        for src in sources:
            out = os.path.join(d, f"lib{src}.so")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out,
                   os.path.join(d, f"{src}.cu")]
            procs.append((name, src, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    entries = {}
    for name, src, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: {src} failed:\n{log}")
        ptxas = [ln for ln in chip_smoke.ptxas_summary(log) if "tf32" in ln]
        print(json.dumps({"variant": name, "source": src, "ptxas": ptxas}))
        fn = getattr(ctypes.CDLL(out), f"mxtt_{src}")
        fn.argtypes = fa._ARGTYPES[src]
        fn.restype = ctypes.c_int
        entries[name, src] = fn
    return entries


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "flash_bwd_variants.json")
    with open(spec_path) as fh:
        specs = json.load(fh)
    print(json.dumps({"device": cs.nvidia_smi(), "torch": torch.__version__}))
    entries = build_variants(build, cs, specs)
    dev = torch.device("cuda:0")
    timer = cs.Timer(torch, dev)

    def launch(name, src, q, k, v, do, ln, lse, delta, causal, sc, window):
        BH, Lq, D = q.shape
        outs = [torch.empty_like(q)] if src == SOURCES[0] else [
            torch.empty_like(k), torch.empty_like(v)]
        rc = entries[name, src](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            ln.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(o.data_ptr() for o in outs), BH, Lq, k.shape[1], D,
            float(sc), int(causal), int(window), 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {name}: {src} launch error {rc}")
        return outs

    g = torch.Generator().manual_seed(5)
    for label, BH, Lq, Lk, D, causal, window, lens in cs._flash_cases():
        # draw every case's inputs, as flash_kernels does, so that the
        # checked cases see the same tensors
        q, k, v, do = (torch.randn(BH, L, D, generator=g)
                       for L in (Lq, Lk, Lk, Lq))
        if label not in CHECKED:
            continue
        q, k, v, do = (t.to(dev) for t in (q, k, v, do))
        ln = torch.tensor(lens if lens is not None else [Lk] * BH,
                          dtype=torch.int32, device=dev)
        sc = 1.0 / D ** 0.5
        out, lse = fa.flash_attention_fwd_reference(q, k, v, ln, causal,
                                                    sc, window)
        delta = (do * out).sum(-1, keepdim=True)
        args = (q, k, v, do, ln, lse, delta, causal, sc, window)
        plain = (fa.flash_attention_bwd_dq_reference(*args[:4], ln, lse,
                                                     delta, causal, sc,
                                                     window),
                 *fa.flash_attention_bwd_dkv_reference(*args[:4], ln, lse,
                                                       delta, causal, sc,
                                                       window))
        mask = fa._visible(Lq, Lk, ln, causal, window, dev)
        p = torch.where(mask, torch.exp(
            q.double() @ k.double().transpose(1, 2) * sc - lse.double()),
            0.0)
        ds = p * (do.double() @ v.double().transpose(1, 2)
                  - delta.double()) * sc
        exact = (ds @ k.double(), ds.transpose(1, 2) @ q.double(),
                 p.transpose(1, 2) @ do.double())
        del p, ds, mask

        def errs(got, want):
            return dict(zip(("dq", "dk", "dv"),
                            (cs._rel_err(a, b) for a, b in zip(got, want))))
        print(json.dumps({"shape": label, "variant": "plain",
                          "rel_err_vs_fp64": errs(plain, exact)}))
        for name in specs:
            got = [*launch(name, SOURCES[0], *args),
                   *launch(name, SOURCES[1], *args)]
            torch.cuda.synchronize()
            print(json.dumps({"shape": label, "variant": name,
                              "rel_err": errs(got, plain),
                              "rel_err_vs_fp64": errs(got, exact)}),
                  flush=True)
        if label in TIMED:
            for order in (list(specs), list(specs)[::-1]):
                for name in order:
                    t = {src: timer(lambda: launch(name, src, *args))
                         for src in SOURCES}
                    print(json.dumps({"shape": label, "variant": name,
                                      "dq_ms": t[SOURCES[0]],
                                      "dkv_ms": t[SOURCES[1]]}), flush=True)
        del plain, exact
    return 0


if __name__ == "__main__":
    sys.exit(main())
