"""One Hier-Local-QSGD round of the port on the card: exact kernel launch
counts and closed-form ledger bits.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_baselines_cuda.py``.
Without a CUDA device the case skips.
"""
import math

import pytest
import torch

from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
from repro_torch.core.baselines import HierLocalQSGDConfig, run_hier_local_qsgd
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.models.classifier import make_classifier
from repro_torch.optim.local import MomentumSGD
from repro_torch.utils import tree_leaves


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU with nvcc")
def test_hier_local_qsgd_round_on_the_card():
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = [list(range(0, 9)), list(range(9, 15)), list(range(15, 20))]  # uneven
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds, clients,
                  clusters, batch_size=16, seed=0)
    cfg = HierLocalQSGDConfig(rounds=1, local_steps=4, local_epochs=2, eval_every=1,
                              qsgd_levels=16, local_opt=MomentumSGD(0.5))
    leaf_sizes = task.param_leaf_sizes()
    L, J, M = len(leaf_sizes), 2, 3
    build.reset_launches()
    res = run_hier_local_qsgd(task, cfg)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    assert launches["qsgd_quantize_pack"] == launches["qsgd_unpack_dequantize"] == J * L + L
    assert launches["qsgd_quantize"] == launches["qsgd_dequantize"] == 0
    led, d = res.ledger, sum(leaf_sizes)
    up = channel_wire_bits(QSGDChannel(16), d, leaf_sizes)
    assert led.messages["client_to_es"] == J * 20 and led.bits["client_to_es"] == J * 20 * up
    assert led.messages["es_to_ps"] == M and led.bits["es_to_ps"] == M * up
    assert led.bits["ps_to_es"] == M * 32 * d and led.bits["es_to_client"] == J * 20 * 32 * d
    assert all(math.isfinite(x) for x in res.test_acc + res.train_loss)
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params))
