"""Remat lowers the memory of the port's gradients (`utils.grad_and_value`).

One gradient of smoke qwen3-0.6b's `loss_fn` (8 layers, 2 sequences of 256
tokens, f32 on the CPU), taken the ways the port takes it:

* `oracles.grad_phase`, the engine's vmapped per-client step (2 clients,
  one Eq. (5) step);
* `transformer.make_train_step`, one SGD step of one chain.

Each runs with remat off and on, and the peak of live tensor storage
during the call is read (`LiveBytes`: every storage an op makes, from its
making until the last tensor on it is freed, tracked by weakref
finalizers, so the reading is deterministic).  Held:

* remat holds at most 0.6x the plain peak (it keeps each block's input
  and recomputes one block at a time in the backward);
* the plain peak is not above that of `torch.autograd.grad` on the same
  loss: the same per-client gradients of the clients' summed losses, each
  client's loss on its own leaves (for the step, the loss itself).

`torch.func.grad_and_value` fails both: its backward builds a graph that
keeps every recomputed block alive (remat then holds more than plain) and
holds 2.3x autograd's peak without remat.

The helper takes the bits `torch.func.grad_and_value` took over `F.silu`
(whose backward under a graph is the grad-mode formula that
`common.Silu` always takes): loss and every gradient equal, under the
engine's vmap over 2 clients, on smoke configs of four block families
with remat on and off.
"""
import dataclasses
import functools
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _flat_args

from repro_torch.configs.registry import smoke_config
from repro_torch.core import oracles
from repro_torch.models import common, ssd
from repro_torch.models import transformer as tf
from repro_torch.models.fed import LMFedModel
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(1)

LAYERS, CLIENTS, B, T = 8, 2, 2, 256
REMAT_BOUND = 0.6


class LiveBytes(TorchDispatchMode):
    """The peak bytes of the storages made by the ops run inside it and
    still referenced by a tensor.  A storage an op makes counts from the op
    until the last tensor on it that an op returned is freed; a view or an
    in-place result of a tracked storage holds it too, one of a storage
    made before the block (the params) is not counted."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}  # storage address -> [bytes, tensors]
        self.now = self.peak = 0

    def _release(self, key):
        entry = self.live[key]
        entry[1] -= 1
        if not entry[1]:
            del self.live[key]
            self.now -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr() for t in _flat_args((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in _flat_args(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if key in self.live:
                self.live[key][1] += 1
            elif key in inputs or not storage.nbytes():
                continue
            else:
                self.live[key] = [storage.nbytes(), 1]
                self.now += storage.nbytes()
                self.peak = max(self.peak, self.now)
            weakref.finalize(t, self._release, key)
        return out


def peak(fn) -> int:
    with LiveBytes() as m:
        out = fn()
    del out
    return m.peak


def _autograd(cfg, params, batches):
    """Per-batch gradients of the batches' summed losses by
    `torch.autograd.grad`, each batch's loss on its own detached leaves
    (views of the params: no copy)."""
    leaves, treedef = tree_flatten(params)
    own = [[t.detach().requires_grad_() for t in leaves] for _ in batches]
    loss = sum(tf.loss_fn(cfg, tree_unflatten(treedef, ls), b) for ls, b in zip(own, batches))
    return torch.autograd.grad(loss, [t for ls in own for t in ls])


@functools.lru_cache(maxsize=None)
def peaks():
    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"), num_layers=LAYERS)
    params = tf.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, CLIENTS, B, T + 1), generator=gen)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    gammas = torch.full((CLIENTS,), 1.0 / CLIENTS)
    lrs = torch.tensor([0.1])
    one = tree_map(lambda a: a[0, 0], batch)
    out = {}
    for remat in (False, True):
        phase = oracles.grad_phase(LMFedModel(cfg, remat=remat))
        out["grad_phase", remat] = peak(lambda: phase(params, batch, gammas, lrs))
        step = tf.make_train_step(cfg, remat=remat)
        out["train_step", remat] = peak(lambda: step(params, one, 0.1))
    out["grad_phase", "autograd"] = peak(lambda: _autograd(
        cfg, params, [tree_map(lambda a, c=c: a[0, c], batch) for c in range(CLIENTS)]))
    out["train_step", "autograd"] = peak(lambda: _autograd(cfg, params, [one]))
    return out


@pytest.mark.parametrize("path", ["grad_phase", "train_step"])
def test_remat_holds_less_than_the_plain_gradient(path):
    p = peaks()
    plain, remat = p[path, False], p[path, True]
    print(f"{path}: plain {plain / 2**20:.1f} MiB, remat {remat / 2**20:.1f} MiB, "
          f"{remat / plain:.3f}x")
    assert remat <= REMAT_BOUND * plain


@pytest.mark.parametrize("path", ["grad_phase", "train_step"])
def test_plain_gradient_holds_no_more_than_autograd(path):
    p = peaks()
    plain, ref = p[path, False], p[path, "autograd"]
    print(f"{path}: plain {plain / 2**20:.1f} MiB, autograd {ref / 2**20:.1f} MiB")
    assert plain <= ref


@pytest.mark.parametrize("arch,flash", [("qwen3-0.6b", True), ("dbrx-132b", False),
                                        ("deepseek-v3-671b", False), ("mamba2-370m", False)])
@pytest.mark.parametrize("remat", [False, True])
def test_gradients_equal_torch_func_over_f_silu(arch, flash, remat, monkeypatch):
    from repro_torch.utils import grad_and_value

    cfg = dataclasses.replace(smoke_config(arch), use_flash=flash)
    params = tf.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 17), generator=gen)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}

    def loss(p, b):
        return tf.loss_fn(cfg, p, b, remat=remat)

    got = torch.func.vmap(grad_and_value(loss), in_dims=(None, 0))(params, batch)
    for module in (common, ssd):
        monkeypatch.setattr(module, "silu", torch.nn.functional.silu)
    want = torch.func.vmap(torch.func.grad_and_value(loss), in_dims=(None, 0))(params, batch)
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])))
