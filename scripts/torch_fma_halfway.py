#!/usr/bin/env python3
"""How often the CPU's plain weight draw could differ from a true fused
multiply-add, counted on the CPU.

    PYTHONPATH=src python scripts/torch_fma_halfway.py --entries 16777216 --keys 4

`kernels/ref.py::normal_ref` computes each of XLA's fused multiply-adds
(`__fmaf_rn` on the card) as an f64 product and sum rounded to f32.  That
rounds twice, and differs from one rounding only where the f64 sum lies
exactly halfway between two f32 values while the exact sum does not.  This
script draws `--entries` entries under each of `--keys` keys with every FMA
of the draw checked: it counts, per FMA site (the line of `kernels/ref.py`),
the halfway sums, and how many of them were inexact (a two-sum error other
than zero): those are the entries where the plain draw and the kernel could
disagree.
"""
from __future__ import annotations

import argparse
import collections
import traceback

import numpy as np

import repro_torch.kernels.ref as ref
from repro_torch.core import prng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=1 << 24)
    ap.add_argument("--keys", type=int, default=4)
    args = ap.parse_args(argv)
    exact, inexact = collections.Counter(), collections.Counter()

    def checked(self, a, b, c, out):
        p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        c64 = np.broadcast_to(np.asarray(c, np.float64), p.shape)
        s = p + c64
        tie = (s.view(np.int64) & ((1 << 29) - 1)) == (1 << 28)
        if tie.any():
            site = traceback.extract_stack(limit=2)[0].lineno
            t, pt, ct = s[tie], p[tie], c64[tie]
            back = t - pt  # two-sum: the exact error of t = p + c
            err = (pt - (t - back)) + (ct - back)
            exact[site] += int((err == 0).sum())
            inexact[site] += int((err != 0).sum())
        out[...] = s
        return out

    ref._Fma.__call__ = checked
    for k in range(args.keys):
        ref.normal_ref(prng.split(prng.PRNGKey(k), 2)[1], 0, args.entries, 1.0)
    total = args.entries * args.keys
    print(f"{total} entries under {args.keys} keys; halfway f64 sums by line of kernels/ref.py:")
    for site in sorted(set(exact) | set(inexact)):
        print(f"  line {site}: {exact[site]} exact (rounded to even, as one rounding does), "
              f"{inexact[site]} inexact")
    print(f"entries where the plain draw can differ from a true FMA: {sum(inexact.values())}")


if __name__ == "__main__":
    main()
