"""The port's lowering and dry run on the CPU (`launch.steps`,
`launch.dryrun`, `sharding.specs.named_shardings`):

* per-device dot FLOPs of the reference's six tiny-shape cases
  (`tests/test_sharding_dryrun.py::test_mini_dryrun_lowers_on_debug_mesh`)
  at (1, 1) against the reference's `analyze_compiled`: the decode steps
  and dbrx's train round equal; qwen3's and mamba2's train rounds are
  pinned at their measured ratios, 1.0377 and 1.0685 (ROADMAP Queue C):
  XLA drops the last product of each rematerialised block (its output
  feeds nothing in the backward), which the port's eager recompute runs;
* `named_shardings` of the smoke configs of qwen3-0.6b, dbrx-132b and
  whisper-tiny (vocab 51865: the divisibility guard) equal the reference's
  `PartitionSpec`s read axis by axis, on a (16, 16) mesh;
* `abstract_params` of deepseek-v3-671b allocates nothing;
* `python -m repro_torch.launch.dryrun` writes a record with the
  reference's keys, priced on H100, and leaves no process group behind.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

import repro_torch.launch.steps as steps
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.roofline import analyze_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(a, s) for a in ("qwen3-0.6b", "mamba2-370m", "dbrx-132b")
         for s in ("train_4k", "decode_32k")]
# port / reference per-device dot FLOPs, measured: the remat recompute's
# last product of each block, which XLA removes as dead code
PINNED = {("qwen3-0.6b", "train_4k"): 1.0377, ("mamba2-370m", "train_4k"): 1.0685}


def _tiny(mod, shape):
    tiny = dict(mod.SHAPES)
    tiny[shape] = dict(tiny[shape], seq_len=64, global_batch=2)
    return tiny


def port_flops(arch, shape):
    orig = steps.SHAPES
    steps.SHAPES = _tiny(steps, shape)
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        trace = steps.lower_spec(steps.build_lowering(smoke_config(arch), shape, mesh), mesh)
    finally:
        steps.SHAPES = orig
    return analyze_trace(trace)["dot_flops_per_device"]


def ref_flops(arch, shape):
    import repro.launch.steps as rsteps
    from repro.configs.registry import smoke_config as ref_smoke
    from repro.launch.mesh import make_debug_mesh as ref_mesh
    from repro.roofline.analysis import analyze_compiled

    orig = rsteps.SHAPES
    rsteps.SHAPES = _tiny(rsteps, shape)
    try:
        mesh = ref_mesh(1, 1)
        spec = rsteps.build_lowering(ref_smoke(arch), shape, mesh)
        compiled = rsteps.lower_spec(spec, mesh).compile()
    finally:
        rsteps.SHAPES = orig
    return analyze_compiled(compiled)["dot_flops_per_device"]


@pytest.mark.parametrize("arch,shape", CASES)
def test_dot_flops_match_reference_at_1x1(arch, shape):
    ratio = port_flops(arch, shape) / ref_flops(arch, shape)
    assert ratio == pytest.approx(PINNED.get((arch, shape), 1.0), abs=1e-4)


class FakeMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b", "whisper-tiny"])
def test_named_shardings_match_reference_specs(arch):
    import jax
    from jax.sharding import PartitionSpec as RP

    from repro.configs.registry import smoke_config as ref_smoke
    from repro.models import transformer as rtf
    from repro.sharding.specs import param_pspecs as ref_pspecs
    from repro_torch.sharding.specs import named_shardings, param_pspecs
    from repro_torch.utils import tree_leaves

    cfg, rcfg = smoke_config(arch), ref_smoke(arch)
    if arch == "whisper-tiny":
        cfg, rcfg = (dataclasses.replace(c, vocab_size=51865) for c in (cfg, rcfg))
    rparams = jax.eval_shape(lambda: rtf.init_params(rcfg, jax.random.PRNGKey(0)))
    want = jax.tree.leaves(ref_pspecs(rparams, num_experts=rcfg.num_experts, mesh=FakeMesh()),
                           is_leaf=lambda x: isinstance(x, RP))
    got = tree_leaves(named_shardings(FakeMesh(), param_pspecs(
        steps.abstract_params(cfg), num_experts=cfg.num_experts, mesh=FakeMesh())))
    assert len(got) == len(want)
    for sh, spec in zip(got, want):
        for axis, placement in zip(FakeMesh.axis_names, sh.placements):
            dims = [i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            if dims:
                assert placement.is_shard(dims[0]), (spec, sh)
            else:
                assert placement.is_replicate(), (spec, sh)


def test_tuple_entries_split_major_to_minor():
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.specs import NamedSharding, PartitionSpec as P

    mesh = type("M", (), {"axis_names": ("pod", "data", "model")})()
    assert NamedSharding(mesh, P(("pod", "data"), None)).placements[:2] == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="order"):
        NamedSharding(mesh, P(("model", "data"))).placements  # noqa: B018


def test_abstract_params_of_deepseek_allocate_nothing():
    from repro_torch.configs.registry import get_config
    from repro_torch.utils import tree_leaves

    t0 = time.time()
    leaves = tree_leaves(steps.abstract_params(get_config("deepseek-v3-671b")))
    assert time.time() - t0 < 30
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 7e11


def test_dryrun_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
                        "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__single__fedchs.json").read_text())
    for key in ("dot_flops_per_device", "dot_flops_by_dtype", "collectives",
                "collective_bytes_per_device", "memory", "compute_s", "memory_s",
                "collective_s", "bound", "model_flops", "chips"):
        assert key in rec
    assert rec["chips"] == 256 and rec["hw"] == "H100" and rec["memory"]["peak_bytes"] > 0
