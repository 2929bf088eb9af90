"""The federation mesh on the card: two `gloo` ranks sharing one CUDA
device run Fed-CHS QSGD(16) on the tiny task of
`tests/test_torch_sharding.py` (a (1, 2) mesh), against the single-device
run on the same card.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_sharding_cuda.py``.
Without a CUDA device every case skips.

* Params, eval trace and ledger equal the single-device run's, and the
  train losses are within rtol 1e-6 (if cuBLAS picks its product by the
  lane count, the params are held at 1e-6 of their update instead, beside
  the printed gap).
* The ranks' QSGD launches add up to twice the single run's: each rank
  encodes and decodes its own senders, one launch per leaf an
  interaction (rounds x K/E x leaves each).
* The mesh run took the plan's own chunk (the eager executor), and gloo
  all-gathers CUDA tensors in rank order over the mesh's groups.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_federation_mesh, spawn_ranks
from repro_torch.sharding.specs import FED_AXES
from repro_torch.utils import tree_leaves

from test_torch_sharding import summary, tiny_task

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU with nvcc")

FIELDS = dict(rounds=6, local_steps=4, local_epochs=2, qsgd_levels=16, eval_every=3, seed=0)


def rank_run(rank: int) -> dict:
    torch.cuda.set_device(0)
    mesh = make_federation_mesh(1, 2)
    assert mesh.device == torch.device("cuda", 0) and mesh.size == 2
    x = torch.full((3,), float(rank), device=mesh.device)
    gathered = mesh.all_gather({"x": x}, FED_AXES)["x"]
    build.reset_launches()
    res = run_fed_chs(tiny_task(device="cuda"), FedCHSConfig(**FIELDS, mesh=mesh))
    return {"run": summary(res), "launches": dict(build.LAUNCHES),
            "executor": engine.LAST_STATS["executor"], "gathered": gathered.cpu().numpy()}


@needs_card
def test_fed_chs_qsgd_mesh_on_the_card(tmp_path):
    build.build()
    build.reset_launches()
    task = tiny_task(device="cuda")
    single = summary(run_fed_chs(task, FedCHSConfig(**FIELDS)))
    solo_launches = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    ranks = spawn_ranks(rank_run, 2, tmp_dir=str(tmp_path))
    leaves = len(single["params"])
    per_rank = FIELDS["rounds"] * FIELDS["local_steps"] // FIELDS["local_epochs"] * leaves
    assert solo_launches["qsgd_quantize_pack"] == per_rank
    p0 = [a.cpu().numpy() for a in tree_leaves(task.init_params())]
    update = max(float(np.max(np.abs(w - p))) for w, p in zip(single["params"], p0))
    for r in ranks:
        np.testing.assert_array_equal(r["gathered"], [0, 0, 0, 1, 1, 1])
        assert r["executor"] == "chunk_fn"
        assert r["launches"]["qsgd_quantize_pack"] == per_rank
        assert r["launches"]["qsgd_unpack_dequantize"] == per_rank
        got = r["run"]
        gap = max(float(np.max(np.abs(a.astype(np.float64) - b)))
                  for a, b in zip(got["params"], single["params"]))
        print(f"mesh vs single params gap {gap:.3g} (update {update:.3g})")
        assert gap <= 1e-6 * update
        assert got["total_bits"] == single["total_bits"]
        assert got["history"] == single["history"] and got["events"] == single["events"]
        np.testing.assert_allclose(got["train_loss"], single["train_loss"], rtol=1e-5)
