#!/usr/bin/env python3
"""A dry run's collective bytes a device, split by kind and shape.

    PYTHONPATH=src python scripts/torch_dryrun_collectives.py --arch deepseek-v3-671b \
        --shape decode_32k                                   # the (16, 16) pod
    PYTHONPATH=src python scripts/torch_dryrun_collectives.py --arch deepseek-v3-671b \
        --shape decode_32k --smoke --mesh 2,4 --seq 32768 --batch 8

It lowers one step as `python -m repro_torch.launch.dryrun --mesh single`
does (`launch.steps.lower_spec` under `launch.mesh.fake_world`; with
`--mesh data,model` on that debug mesh instead, and `--smoke` the arch's
smoke config), and prints the total collective bytes a device, the dot
FLOPs and the peak, then each (kind, shape) of collective with its bytes,
largest first.  Which package it lowers is the one first on `PYTHONPATH`,
so pointing it at another checkout's `src` reads that tree's step.
"""
from __future__ import annotations

import argparse
import collections

import repro_torch.launch.steps as steps
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.launch.mesh import POD_CHIPS, fake_world, make_debug_mesh, make_production_mesh
from repro_torch.roofline import analyze_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(steps.SHAPES))
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--mesh", help="data,model: a debug mesh (default the (16, 16) pod)")
    ap.add_argument("--seq", type=int, help="the shape's sequence, cut or stretched")
    ap.add_argument("--batch", type=int, help="the shape's global batch")
    ap.add_argument("--top", type=int, default=12, help="rows to print")
    a = ap.parse_args(argv)

    cfg = smoke_config(a.arch) if a.smoke else get_config(a.arch)
    steps.SHAPES = dict(steps.SHAPES)
    steps.SHAPES[a.shape] = dict(steps.SHAPES[a.shape], **{
        k: v for k, v in (("seq_len", a.seq), ("global_batch", a.batch)) if v})
    data, model = (int(x) for x in a.mesh.split(",")) if a.mesh else (None, None)
    with fake_world(data * model if a.mesh else POD_CHIPS):
        mesh = (make_debug_mesh(data, model, device="cpu") if a.mesh
                else make_production_mesh(multi_pod=False, device="cpu"))
        trace = steps.lower_spec(steps.build_lowering(cfg, a.shape, mesh), mesh)
    r = analyze_trace(trace)
    print(f"{cfg.name} {a.shape} {steps.SHAPES[a.shape]}: collectives "
          f"{r['collective_bytes_per_device']:.0f} B a device, dot FLOPs "
          f"{r['dot_flops_per_device']:.0f}, peak {r['memory']['peak_bytes']:.0f} B")
    by = collections.Counter()
    for event in trace.events:
        if event[7] is not None:  # (op, ..., output shape, scope, kind, bytes)
            by[event[7], event[5]] += event[8]
    for (kind, shape), nbytes in by.most_common(a.top):
        print(f"{nbytes:16.0f} B  {kind} {shape}")


if __name__ == "__main__":
    main()
