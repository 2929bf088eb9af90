"""The paper's Appendix-A models, MLP and LeNet, as plain torch functions.

* MLP — two hidden FC layers: 200/200 (MNIST), 256/512 (CIFAR-10/100), ReLU.
* LeNet — two conv+pool stages then two FC layers:
  MNIST: conv 64@5x5 -> pool 2x2 -> conv 256@5x5 -> pool -> FC 512 -> FC 128.
  CIFAR: conv 64@5x5 -> pool -> conv 64@5x5 -> pool -> FC 384 -> FC 192.

Parameters are nested dicts of tensors in the reference package's layout:
dense weights (in, out), conv weights (H, W, I, O), images NHWC.  QSGD cuts
its blocks from each leaf flattened row-major, so the layout is part of the
wire format: the forward pass transposes only inside, and LeNet flattens
its last feature map in NHWC order as the reference does.  `init(seed)`
draws the reference's `init(jax.random.PRNGKey(seed))` bit for bit (the
port's threefry and `prng.normal`), on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.utils import grad_and_value, resolve_device


@dataclasses.dataclass(frozen=True)
class Classifier:
    name: str
    init: Callable[..., dict]  # (seed, device=None) -> params
    apply: Callable[[dict, torch.Tensor], torch.Tensor]  # (params, x NHWC) -> logits
    num_classes: int

    def loss(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.apply(params, x), dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None].long()))

    def loss_and_grad(self, params: dict, x: torch.Tensor, y: torch.Tensor):
        """(loss, grads), as `jax.value_and_grad(loss)` returns them."""
        grads, loss = grad_and_value(self.loss)(params, x, y)
        return loss, grads

    def accuracy(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(self.apply(params, x), dim=-1)
        return torch.mean((pred == y.to(pred.device)).float())


@functools.lru_cache(maxsize=8)
def _draw(layers: tuple, seed: int) -> dict:
    """The host tree that the reference's `init(jax.random.PRNGKey(seed))`
    draws for `layers`, ((name, weight shape), ...) in key order: layer i
    takes `split(key, len(layers))[i]`, its weight the normal of that key's
    first split times the He scale sqrt(2 / fan_in), its bias zeros.  A run
    asks for its initial params more than once (sizes, then the run), and
    arms of a comparison share a seed, so recent trees are kept."""
    tree = {}
    for (name, shape), key in zip(layers, prng.split(prng.PRNGKey(seed), len(layers))):
        scale = np.float32(np.sqrt(2.0 / int(np.prod(shape[:-1]))))
        tree[name] = {"w": prng.normal(prng.split(key)[0], shape) * scale,
                      "b": np.zeros((shape[-1],), np.float32)}
    return tree


def _host_init(layers: tuple) -> Callable[..., dict]:
    def init(seed: int = 0, device=None):
        """He-normal weights, zero biases: the reference's draw from
        `jax.random.PRNGKey(seed)`, bit for bit, made on the host."""
        return _to_device(_draw(layers, seed), resolve_device(device))

    return init


def _to_device(tree: dict, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else torch.tensor(v, device=device)
            for k, v in tree.items()}


def _dense(x, p):
    return x @ p["w"] + p["b"]


def _conv(x, p):
    """SAME 2-D convolution (odd kernels: symmetric padding), NCHW
    activations, HWIO weights."""
    kh, kw = p["w"].shape[:2]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=(kh // 2, kw // 2))


def _mlp_dims(dataset: str) -> tuple[int, int]:
    return (200, 200) if dataset == "mnist" else (256, 512)


def make_mlp(dataset: str, image_shape: tuple[int, int, int], num_classes: int) -> Classifier:
    h1, h2 = _mlp_dims(dataset)
    d_in = int(np.prod(image_shape))

    init = _host_init((("fc1", (d_in, h1)), ("fc2", (h1, h2)), ("out", (h2, num_classes))))

    def apply(params, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_dense(x, params["fc1"]))
        x = torch.relu(_dense(x, params["fc2"]))
        return _dense(x, params["out"])

    return Classifier(f"mlp-{dataset}", init, apply, num_classes)


def make_lenet(dataset: str, image_shape: tuple[int, int, int], num_classes: int,
               *, width_scale: float = 1.0) -> Classifier:
    """width_scale < 1 shrinks channel/FC widths uniformly (small CPU tests);
    1.0 is the paper's Appendix-A LeNet exactly."""
    h, w, c = image_shape
    if dataset == "mnist":
        c1, c2, f1, f2 = 64, 256, 512, 128
    else:
        c1, c2, f1, f2 = 64, 64, 384, 192
    if width_scale != 1.0:
        c1, c2, f1, f2 = (max(8, int(v * width_scale)) for v in (c1, c2, f1, f2))
    flat = (h // 4) * (w // 4) * c2  # two 2x2 pools

    init = _host_init((("conv1", (5, 5, c, c1)), ("conv2", (5, 5, c1, c2)),
                       ("fc1", (flat, f1)), ("fc2", (f1, f2)), ("out", (f2, num_classes))))

    def apply(params, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(_conv(x, params["conv1"])), 2)
        x = F.max_pool2d(torch.relu(_conv(x, params["conv2"])), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = torch.relu(_dense(x, params["fc1"]))
        x = torch.relu(_dense(x, params["fc2"]))
        return _dense(x, params["out"])

    return Classifier(f"lenet-{dataset}", init, apply, num_classes)


def make_classifier(model: str, dataset: str, image_shape, num_classes: int,
                    *, width_scale: float = 1.0) -> Classifier:
    if model == "mlp":
        return make_mlp(dataset, tuple(image_shape), num_classes)
    if model == "lenet":
        return make_lenet(dataset, tuple(image_shape), num_classes, width_scale=width_scale)
    raise ValueError(f"unknown model {model!r}")
