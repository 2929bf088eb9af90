"""The port's dry run on a model mesh, held to the reference's on the same
mesh (`launch.steps.lower_spec` under `launch.mesh.fake_world` against
`repro.launch.steps.lower_spec(...).compile()` read by the reference's
`analyze_compiled`).

Smoke configs of qwen3-0.6b (dense), dbrx-132b (MoE), deepseek-v3-671b
(MLA + MoE) and mamba2-370m (SSD: its train round takes `ssd._streams`'
gathered-weight path, its decode step the activation path), at train_4k and decode_32k cut to the tiny sequence of
`tests/test_torch_dryrun.py` (64) and a global batch of 8 (the batch splits
over "data"), on a (data 2, model 4) debug mesh of 8 ranks.  The reference
runs once, in a subprocess with 8 forced host devices.  Per device:

* dot FLOPs at most 1.10x the reference's (qwen3's train round over its
  remat pin, 1.0377: XLA drops the last product of each rematerialised
  block); and the port's 8 ranks together do between 0.9x and 1.10x the
  work of its one-device run of the same step: no product repeats across
  ranks, and none is dropped.  The
  MoE rounds read below the reference: its GSPMD program runs each
  expert's slots on every data shard, the port's `moe_routed_global` one
  block of them on each;
* collective bytes and peak memory at most 2x the reference's.  An
  all-to-all is billed as the card's (`fake_world` routes DTensor's re-split
  through `_dtensor::shard_dim_alltoall`), not as gloo's gather-and-chunk.

deepseek-v3-671b's decode also runs at decode_32k's own sequence, 32768
(`LONG`), where its latent caches (`c_kv`, `k_rope`, split on the
sequence over "model") are most of the step's inputs: held to the same
bounds, so a decode that gathers its caches fails.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import repro_torch.launch.steps as steps
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.roofline import analyze_trace
from repro_torch.utils import tree_leaves

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a torch subprocess runs on one thread, as this process does: the test
# command runs several workers on the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
DATA, MODEL = 2, 4
SEQ, BATCH = 64, 8
ARCHS = ("qwen3-0.6b", "dbrx-132b", "deepseek-v3-671b", "mamba2-370m")
SHAPES = ("train_4k", "decode_32k")
PINNED = {("qwen3-0.6b", "train_4k"): 1.0377}
LONG = {("deepseek-v3-671b", "decode_32k"): 32768}  # (arch, shape) -> sequence
KEYS = ("dot_flops_per_device", "collective_bytes_per_device", "peak_bytes")

# run in the subprocess: every case's reference numbers, one JSON line
_REF = """
import json, sys
import repro.launch.steps as rsteps
from repro.configs.registry import smoke_config
from repro.launch.mesh import make_debug_mesh
from repro.roofline.analysis import analyze_compiled
data, model, batch = (int(a) for a in sys.argv[1:4])
out, shapes = {}, dict(rsteps.SHAPES)
for case in sys.argv[4].split(","):  # arch/shape/seq
    arch, shape, seq = case.split("/")
    rsteps.SHAPES = dict(shapes)
    rsteps.SHAPES[shape] = dict(shapes[shape], seq_len=int(seq), global_batch=batch)
    mesh = make_debug_mesh(data, model)
    r = analyze_compiled(rsteps.lower_spec(
        rsteps.build_lowering(smoke_config(arch), shape, mesh), mesh).compile())
    out[case] = [r["dot_flops_per_device"], r["collective_bytes_per_device"],
                 r["memory"]["peak_bytes"]]
print(json.dumps(out))
"""

CASES = [(a, s, SEQ) for a in ARCHS for s in SHAPES] + [(a, s, q) for (a, s), q in LONG.items()]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DATA * MODEL}", **ONE_THREAD)
    r = subprocess.run([sys.executable, "-c", _REF, str(DATA), str(MODEL), str(BATCH),
                        ",".join(f"{a}/{s}/{q}" for a, s, q in CASES)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    return {tuple(k.split("/")[:2]) + (int(k.split("/")[2]),): dict(zip(KEYS, v))
            for k, v in rows.items()}


def port(arch: str, shape: str, data: int, model: int, seq: int = SEQ) -> dict:
    orig = steps.SHAPES
    steps.SHAPES = dict(orig)
    steps.SHAPES[shape] = dict(orig[shape], seq_len=seq, global_batch=BATCH)
    try:
        with fake_world(data * model) if data * model > 1 else _nothing():
            mesh = make_debug_mesh(data, model, device="cpu")
            spec = steps.build_lowering(smoke_config(arch), shape, mesh)
            trace = steps.lower_spec(spec, mesh)
    finally:
        steps.SHAPES = orig
    r = analyze_trace(trace)
    nbytes = [sum(t.numel() * t.element_size() for t in tree_leaves(a)
                  if isinstance(t, torch.Tensor)) for a in spec.args]
    return {"dot_flops_per_device": r["dot_flops_per_device"],
            "collective_bytes_per_device": r["collective_bytes_per_device"],
            "peak_bytes": r["memory"]["peak_bytes"],
            # of the step's whole inputs (params, caches, token), the caches' share
            "cache_share": nbytes[1] / sum(nbytes) if shape.startswith("decode") else 0.0}


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_dry_run_holds_the_reference(reference, arch, shape):
    ref = reference[arch, shape, SEQ]
    got = port(arch, shape, DATA, MODEL)
    ratios = {k: got[k] / ref[k] for k in KEYS}
    print(f"{arch} {shape} (data {DATA}, model {MODEL}): port / reference "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    assert ratios["dot_flops_per_device"] <= 1.10 * PINNED.get((arch, shape), 1.0)
    assert ratios["collective_bytes_per_device"] <= 2.0
    assert ratios["peak_bytes"] <= 2.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_ranks_do_not_repeat_work(arch, shape):
    one = port(arch, shape, 1, 1)["dot_flops_per_device"]
    ranks = port(arch, shape, DATA, MODEL)["dot_flops_per_device"] * DATA * MODEL
    print(f"{arch} {shape}: {DATA * MODEL} ranks / one device {ranks / one:.3f}")
    assert 0.9 * one <= ranks <= 1.10 * one


@pytest.mark.parametrize("arch,shape", list(LONG))
def test_mesh_decode_holds_the_reference_where_the_cache_dominates(reference, arch, shape):
    seq = LONG[arch, shape]
    ref, got = reference[arch, shape, seq], port(arch, shape, DATA, MODEL, seq)
    ratios = {k: got[k] / ref[k] for k in KEYS}
    print(f"{arch} {shape} at seq {seq} (data {DATA}, model {MODEL}): caches "
          f"{got['cache_share']:.2f} of the step's inputs; port / reference "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    assert got["cache_share"] > 0.5
    assert ratios["dot_flops_per_device"] <= 1.10
    assert ratios["collective_bytes_per_device"] <= 2.0
    assert ratios["peak_bytes"] <= 2.0
