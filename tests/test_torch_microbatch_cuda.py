"""The memory-lean engine on the card: kernel launch counts under
`client_microbatch`, `Precision()` and `LMFedModel(remat=True)`.

Imports no jax, so it runs on a machine with a card and no jax:
``PYTHONPATH=src python -m pytest -q tests/test_torch_microbatch_cuda.py``.
Without a CUDA device the cases skip.
"""
import math

import pytest
import torch

from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
from repro_torch.configs.registry import smoke_config
from repro_torch.core.baselines import HierLocalQSGDConfig, run_hier_local_qsgd
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.precision import Precision
from repro_torch.core.simulation import FLTask
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.sources import TokenSource
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.models.classifier import make_classifier
from repro_torch.models.fed import LMFedModel
from repro_torch.optim.local import MomentumSGD
from repro_torch.utils import tree_leaves

NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU with nvcc")


@NEEDS_CARD
@pytest.mark.parametrize("mb", [2, 4])
def test_microbatched_hier_round_launches_per_group(mb):
    """B1 and B2 run once per leaf per group of mb slots of every cluster,
    ceil(n_max / mb) times per interaction, plus once per leaf at the ES
    hop; the ledger is the unbatched one, and the params stay f32 under
    `Precision()`."""
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = [list(range(0, 9)), list(range(9, 15)), list(range(15, 20))]  # uneven
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds, clients,
                  clusters, batch_size=16, seed=0)
    cfg = HierLocalQSGDConfig(rounds=1, local_steps=4, local_epochs=2, eval_every=1,
                              qsgd_levels=16, local_opt=MomentumSGD(0.5),
                              client_microbatch=mb, precision=Precision())
    leaf_sizes = task.param_leaf_sizes()
    L, J, M = len(leaf_sizes), 2, 3
    build.reset_launches()
    res = run_hier_local_qsgd(task, cfg)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = J * math.ceil(9 / mb) * L + L
    assert launches["qsgd_quantize_pack"] == launches["qsgd_unpack_dequantize"] == want
    led, d = res.ledger, sum(leaf_sizes)
    up = channel_wire_bits(QSGDChannel(16), d, leaf_sizes)
    assert led.messages["client_to_es"] == J * 20 and led.bits["client_to_es"] == J * 20 * up
    assert led.bits["ps_to_es"] == M * 16 * d and led.bits["es_to_client"] == J * 20 * 16 * d
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in tree_leaves(res.final_params))


@NEEDS_CARD
def test_lean_lm_round_launches_flash_twice_per_layer_and_step():
    """Fed-CHS on the 2-layer smoke-config LM under all three knobs: the
    bf16 flash forward twice per layer per client group and step (forward
    and recompute), the f32 one once per layer per eval batch; QSGD(16)
    uplinks once per leaf per group and interaction."""
    cfg = smoke_config("qwen3-0.6b")
    source = TokenSource(cfg.vocab_size, num_clients=4, batch_size=2, seq_len=64, topics=4,
                         seed=0)
    task = FLTask.from_source(LMFedModel(cfg, remat=True, flash=True), source,
                              [[0, 2], [1, 3]], seed=0)
    R, K, E, mb = 2, 2, 1, 1
    config = FedCHSConfig(rounds=R, local_steps=K, local_epochs=E, eval_every=1,
                          channel=QSGDChannel(16), seed=0, schedule=lambda k: 0.3,
                          client_microbatch=mb, precision=Precision())
    build.reset_launches()
    res = run_fed_chs(task, config)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    L = len(tree_leaves(res.final_params))
    groups = math.ceil(2 / mb)
    evals = len(res.rounds) * len(source.eval_data()["tokens"])
    assert launches["flash_attention"] == cfg.num_layers * (R * K * groups * 2 + evals)
    assert launches["qsgd_quantize_pack"] == launches["qsgd_unpack_dequantize"] == \
        R * (K // E) * groups * L
    assert all(math.isfinite(x) for x in res.test_acc + res.train_loss)
    assert all(t.dtype == torch.float32 for t in tree_leaves(res.final_params))
