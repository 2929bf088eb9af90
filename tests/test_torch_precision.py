"""The port's mixed-precision policy (`repro_torch.core.precision`) and the
engine and drivers under it, against the reference package.

Integer results are held exactly: the channel rules, wire widths, payload
bytes and whole-run ledgers (uplinks and broadcasts at the wire width).

The engine's cast placement is held bit for bit against the composition it
ports (params, batch and step sizes cast down once per interaction, raw
deltas in the compute dtype, cast up before the gamma-weighted aggregate,
params back in the master dtype).

Params under `Precision()` against the reference: both packages train in
bf16, but the two autodiff systems round some derivatives at other places
(the reference's tanh rule is g * (1 + y) * (1 - y), torch's
g * (1 - y * y); XLA fuses the log-softmax backward), so about half the bf16
gradient entries differ in the last place.  A step's update lr * g is
about 1% of |p| here, so rounding p - lr * g to the bf16 grid of p turns
that into a one-ulp difference of the step at about the same share of
entries.  The params are held to two bf16 ulps (2^-6) of |p_T| in relative
L2; they read 0.09-1.2% after 2 rounds (ROADMAP Queue C).
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import channels as jch
from repro.comm.bits import dtype_bits as jax_dtype_bits
from repro.core import FedCHSConfig as JaxFedCHSConfig
from repro.core import FLTask as JaxFLTask
from repro.core import baselines as jb
from repro.core import precision as jprec
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.data import dirichlet_partition, make_dataset
from repro.models.classifier import make_classifier as jax_make_classifier
from repro.optim import local as jlocal
from repro_torch.comm import channels as tch
from repro_torch.comm.bits import dtype_bits
from repro_torch.core import baselines as tb
from repro_torch.core import precision as tprec
from repro_torch.core.engine import RoundEngine, compress_uplinks
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
from repro_torch.core.oracles import local_opt_steps
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.simulation import FLTask
from repro_torch.models.classifier import make_classifier
from repro_torch.optim import local as tlocal
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

BF16_TOL = 2.0**-6  # two bf16 ulps of |p_T|, relative L2


@pytest.fixture(scope="module")
def tasks():
    """The same data, partition, uneven clusters and initial weights on both
    sides."""
    ds = make_dataset("mnist", train_size=2000, test_size=500, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    perm = np.random.default_rng(3).permutation(20).tolist()
    clusters = [sorted(perm[:9]), sorted(perm[9:15]), sorted(perm[15:])]
    jclf = jax_make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    jtask = JaxFLTask(jclf, ds, clients, clusters, batch_size=16, seed=0)
    p0 = jax.tree.map(np.asarray, jtask.init_params())
    clf = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    clf = dataclasses.replace(clf, init=lambda seed=0, device=None: params_from_jax(p0, device))
    task = FLTask(clf, ds, clients, clusters, batch_size=16, seed=0, device="cpu")
    return jtask, task, p0


def flat(leaves):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in leaves])


def same_channel(t, j):
    """A port channel equals a reference channel: same class, same fields."""
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# --------------------------------------------------------------------------
# the policy and the channel rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["compute", "master", "wire"])
def test_precision_fields_are_validated(field):
    with pytest.raises(ValueError, match=field):
        tprec.Precision(**{field: "float64"})
    with pytest.raises(ValueError, match=field):
        jprec.Precision(**{field: "float64"})
    ok = tprec.Precision(**{field: "float16"})
    assert getattr(ok, field) == "float16"
    assert dataclasses.asdict(tprec.Precision()) == dataclasses.asdict(jprec.Precision())


def test_precision_dtype_table_sync():
    """Every dtype a policy names has a wire width, equal in both packages."""
    assert tprec._SUPPORTED == jprec._SUPPORTED
    assert {dt: dtype_bits(dt) for dt in tprec._SUPPORTED} == \
        {dt: jax_dtype_bits(dt) for dt in jprec._SUPPORTED} == {
            "float32": 32, "bfloat16": 16, "float16": 16, "float8_e4m3fn": 8}
    for dt in tprec._SUPPORTED:
        assert getattr(torch, dt).itemsize * 8 == dtype_bits(dt)


def test_cast_floats_leaves_integers_alone():
    tree = {"x": torch.ones(3), "y": torch.arange(3, dtype=torch.int32),
            "k": torch.zeros(2, dtype=torch.int64), "n": [torch.full((2,), 0.1)]}
    out = tprec.cast_floats(tree, "bfloat16")
    assert out["x"].dtype == out["n"][0].dtype == torch.bfloat16
    assert out["y"] is tree["y"] and out["k"] is tree["k"]
    assert tprec.compute_cast(tree, None) is tree
    assert tprec.master_cast(tree, None) is tree
    assert tprec.master_cast(out, tprec.Precision())["x"].dtype == torch.float32
    # step sizes on the host: the values the compute dtype holds, as the
    # reference's cast of its lr array gives them
    lrs = np.array([[0.1, 0.05], [1 / 3, 0.3]], np.float32)
    got = tprec.compute_cast(lrs, tprec.Precision())
    want = np.asarray(jprec.compute_cast(jnp.asarray(lrs), jprec.Precision()), np.float64)
    np.testing.assert_array_equal(got, want)
    assert tprec.compute_cast(lrs, None) is lrs


@pytest.mark.parametrize("explicit", [False, True], ids=["no_channel", "channel"])
@pytest.mark.parametrize("levels", [None, 16], ids=["dense", "qsgd16"])
@pytest.mark.parametrize("policy", [None, "bf16", "fp16_wire"])
@pytest.mark.parametrize("bits", [32, 16])
def test_resolve_channel_matches_reference(explicit, levels, policy, bits):
    """An explicit channel wins, then qsgd_levels, then the policy's wire."""
    jpol = {None: None, "bf16": jprec.Precision(),
            "fp16_wire": jprec.Precision(wire="float16")}[policy]
    tpol = None if jpol is None else tprec.Precision(**dataclasses.asdict(jpol))
    jc = jch.TopKChannel(0.1) if explicit else None
    tc = tch.TopKChannel(0.1) if explicit else None
    got = tprec.resolve_channel(tpol, tc, levels, bits)
    same_channel(got, jprec.resolve_channel(jpol, jc, levels, bits))
    if explicit:
        assert got is tc
    elif levels is None and tpol is not None:
        assert got.wire_dtype == tpol.wire and got.bits_per_param == dtype_bits(tpol.wire)
    assert tprec.downlink_bits_per_param(tpol, bits) == \
        jprec.downlink_bits_per_param(jpol, bits)


def test_downlink_bits_per_param():
    assert tprec.downlink_bits_per_param(None) == 32
    assert tprec.downlink_bits_per_param(None, 16) == 16
    assert tprec.downlink_bits_per_param(tprec.Precision()) == 16
    assert tprec.downlink_bits_per_param(tprec.Precision(wire="float8_e4m3fn"), 32) == 8
    assert tprec.downlink_bits_per_param(tprec.Precision(wire="float32"), 16) == 32


def test_bf16_dense_wire_payload_is_its_priced_bits(tasks):
    """The bf16 payload `DenseChannel(wire_dtype="bfloat16")` emits weighs
    what the ledger records, half the f32 message, and under `Precision()`
    every uplink and broadcast of a run is priced at that width."""
    _, task, _ = tasks
    channel = tch.DenseChannel(wire_dtype="bfloat16")
    params = task.init_params()
    wires = channel.encode(params)
    measured = sum(w["payload"].numel() * w["payload"].element_size() for w in wires)
    assert all(w["payload"].dtype == torch.bfloat16 for w in wires)
    d = task.num_params()
    priced = tch.channel_wire_bits(channel, d, task.param_leaf_sizes())
    assert measured == priced // 8
    assert priced * 2 == tch.DenseChannel().message_bits(d)
    res = run_fed_chs(task, FedCHSConfig(rounds=2, local_steps=2, eval_every=10,
                                         precision=tprec.Precision()))
    for hop in ("client_to_es", "es_to_client", "es_to_es"):
        bits = [e.n_bits for e in res.ledger.events if e.hop == hop]
        assert bits and all(b == measured * 8 for b in bits), hop


# --------------------------------------------------------------------------
# the engine under a policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spy:
    """A channel that records the dtypes of the deltas it compresses."""

    inner: Any
    seen: list

    @property
    def per_message(self):
        return self.inner.per_message

    @property
    def stochastic(self):
        return self.inner.stochastic

    def compress(self, tree, keys=None):
        self.seen.append({leaf.dtype for leaf in tree_leaves(tree)})
        return self.inner.compress(tree, keys)


def round_inputs(task, m, K, E):
    task.reset_loaders(0)
    return task.sample_round_batches(m, K, E)


@pytest.mark.parametrize("mb", [None, "n"], ids=["vmapped", "mb_n"])
@pytest.mark.parametrize("levels", [None, 16], ids=["bf16_wire", "qsgd16"])
def test_cluster_round_casts_as_the_reference_places_them(tasks, levels, mb):
    """One interaction under `Precision()` equals, bit for bit, its
    composition: params, batch and step sizes in bf16, E momentum steps, raw
    deltas in bf16 through the channel, cast up to f32, then the f32
    gamma-weighted aggregate added to the f32 params."""
    _, task, p0 = tasks
    m, n, K, E = 1, 6, 2, 2
    pol = tprec.Precision()
    channel = tprec.resolve_channel(pol, None, levels)
    opt = tlocal.MomentumSGD(0.9)
    batch = round_inputs(task, m, K, E)
    gammas = torch.from_numpy(task.cluster_weights(m))
    lrs = np.full((1, E), 0.05, np.float32)
    _, subs = split_chain(PRNGKey(5), 1)
    params = params_from_jax(p0, "cpu")
    seen = []
    engine = RoundEngine(task.model, Spy(channel, seen), local_opt=opt, precision=pol,
                         client_microbatch=None if mb is None else n)
    state0 = engine.init_opt_state(params, n)
    assert {s.dtype for s in tree_leaves(state0)} == {torch.bfloat16}
    got, state, losses = engine.cluster_round(params, batch, gammas, lrs, subs, state0)
    assert seen == [{torch.bfloat16}]
    assert {t.dtype for t in tree_leaves(got)} == {torch.float32}
    assert {s.dtype for s in tree_leaves(state)} == {torch.bfloat16}

    p_c = tprec.cast_floats(params, "bfloat16")
    step = float(torch.tensor(0.05).to(torch.bfloat16))
    new_p, want_state, _ = local_opt_steps(engine.model, opt)(
        tree_map(lambda a: a.expand((n,) + a.shape), p_c), state0,
        tprec.cast_floats(tree_map(lambda a: a[0], batch), "bfloat16"), [step, step])
    raw = tree_map(lambda a, b: a - b[None], new_p, p_c)
    deltas = compress_uplinks(channel, raw, subs[0])
    want = tree_map(lambda p, d: p + torch.tensordot(gammas, d.float(), dims=1), params, deltas)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(state), tree_leaves(want_state)):
        assert torch.equal(a, b)


def test_adamw_under_a_policy_raises_in_both_packages(tasks):
    """The reference's scan refuses AdamW's promoted moments with a
    TypeError; the port refuses the pair before training."""
    jtask, task, _ = tasks
    kw = dict(rounds=1, local_steps=2, eval_every=1)
    for channel in ("wire", "qsgd"):
        levels = 16 if channel == "qsgd" else None
        with pytest.raises(TypeError):
            jax_run_fed_chs(jtask, JaxFedCHSConfig(precision=jprec.Precision(), qsgd_levels=levels,
                                                   local_opt=jlocal.AdamWOpt(), **kw))
        with pytest.raises(TypeError, match="AdamWOpt"):
            run_fed_chs(task, FedCHSConfig(precision=tprec.Precision(), qsgd_levels=levels,
                                           local_opt=tlocal.AdamWOpt(), **kw))
    with pytest.raises(TypeError):
        jb.run_fedavg(jtask, jb.FedAvgConfig(precision=jprec.Precision(), scan_rounds=False,
                                             local_opt=jlocal.AdamWOpt(), **kw))
    with pytest.raises(TypeError, match="AdamWOpt"):
        tb.run_fedavg(task, tb.FedAvgConfig(precision=tprec.Precision(),
                                            local_opt=tlocal.AdamWOpt(), **kw))
    # MomentumSGD and PlainSGD run
    RoundEngine(task.model, local_opt=tlocal.MomentumSGD(), precision=tprec.Precision())


# --------------------------------------------------------------------------
# whole runs under Precision(), against the reference
# --------------------------------------------------------------------------


def assert_ledgers_equal(jres, res):
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits)
    assert dict(tl.messages) == dict(jl.messages)
    assert tl.breakdown() == jl.breakdown()
    assert tl.history == jl.history
    assert tl.events == jl.events
    assert res.rounds == jres.rounds


def assert_bf16_close(res, jres):
    assert {t.dtype for t in tree_leaves(res.final_params)} == {torch.float32}
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    assert np.linalg.norm(got - want) <= BF16_TOL * np.linalg.norm(want)
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=0.05)
    np.testing.assert_allclose(res.test_acc, jres.test_acc, atol=0.05)


@pytest.mark.parametrize("mb", [None, 2], ids=["vmapped", "mb2"])
@pytest.mark.parametrize("levels", [None, 16], ids=["bf16_wire", "qsgd16"])
@pytest.mark.parametrize("opt", ["plain", "momentum"])
def test_fed_chs_under_precision_matches_reference(tasks, opt, levels, mb):
    jtask, task, _ = tasks
    jopt = None if opt == "plain" else jlocal.MomentumSGD(0.9)
    kw = dict(rounds=2, local_steps=4, local_epochs=2, eval_every=1, qsgd_levels=levels,
              client_microbatch=mb, schedule=lambda k: 0.05)
    jres = jax_run_fed_chs(jtask, JaxFedCHSConfig(precision=jprec.Precision(), local_opt=jopt,
                                                  **kw))
    topt = None if jopt is None else tlocal.MomentumSGD(0.9)
    res = run_fed_chs(task, FedCHSConfig(precision=tprec.Precision(), local_opt=topt, **kw))
    assert_ledgers_equal(jres, res)
    d, sizes = task.num_params(), task.param_leaf_sizes()
    up = tch.channel_wire_bits(tprec.resolve_channel(tprec.Precision(), None, levels), d, sizes)
    assert {e.n_bits for e in res.ledger.events if e.hop == "client_to_es"} == {up}
    assert {e.n_bits for e in res.ledger.events if e.hop != "client_to_es"} == {16 * d}
    assert_bf16_close(res, jres)


def test_baselines_under_precision_match_reference(tasks):
    """FedAvg (bf16 dense wire) and Hier-Local-QSGD (QSGD(16) on both hops,
    the ES->PS hop in f32), microbatched, with MomentumSGD."""
    jtask, task, _ = tasks
    jres = jb.run_fedavg(jtask, jb.FedAvgConfig(
        rounds=2, local_steps=3, eval_every=1, precision=jprec.Precision(), client_microbatch=4,
        local_opt=jlocal.MomentumSGD(0.5), schedule=lambda k: 0.05, scan_rounds=False))
    res = tb.run_fedavg(task, tb.FedAvgConfig(
        rounds=2, local_steps=3, eval_every=1, precision=tprec.Precision(), client_microbatch=4,
        local_opt=tlocal.MomentumSGD(0.5), schedule=lambda k: 0.05))
    assert_ledgers_equal(jres, res)
    assert res.ledger.bits["client_to_ps"] == 2 * 20 * 16 * task.num_params()
    assert_bf16_close(res, jres)
    kw = dict(rounds=2, local_steps=4, local_epochs=2, eval_every=1, client_microbatch=4,
              schedule=lambda k: 0.05)
    jres = jb.run_hier_local_qsgd(jtask, jb.HierLocalQSGDConfig(
        precision=jprec.Precision(), local_opt=jlocal.MomentumSGD(0.9), scan_rounds=False, **kw))
    res = tb.run_hier_local_qsgd(task, tb.HierLocalQSGDConfig(
        precision=tprec.Precision(), local_opt=tlocal.MomentumSGD(0.9), **kw))
    assert_ledgers_equal(jres, res)
    assert res.ledger.bits["ps_to_es"] == 2 * 3 * 16 * task.num_params()
    assert_bf16_close(res, jres)
