"""The port's example twins against the reference's examples, on the CPU:
`examples/torch_{compare_algorithms,dynamic_topology,netsim_tour,
participation_tour}.py`, and the LM twins `examples/torch_{serve_decode,
train_lm_fedchs}.py` (at the end of this file).

Each twin runs in a subprocess through its `main`, at a quarter of its
rounds (`--rounds-div 4`), and hands back its rows.  The reference's same
calls (`examples/{compare_algorithms,...}.py`, same task, same arms, same
cut of the rounds) run here.  Since the classifiers draw the reference's
weights from the same seed, the two runs differ only in the order of float
sums:

* the ledger and netsim columns (bits and messages per hop, uplink MB,
  pass-through rounds, makespans, dropped client-rounds, straggler round
  times) are equal;
* each arm's accuracies (every evaluation) stay within the port's own
  1-ulp control: the largest gap between any two of the port's runs from
  the seed's weights (the twin) and from three nudges of them by 1 ulp
  (`nextafter`: every entry up, every entry down, each entry up or down by
  a seeded coin), run here through the twin's `main`.  Float order alone
  moves a run this far; the reference's run is one more such run (on
  compare_algorithms' Top-5% arm the twin is 0.008 from the reference and
  0.007 from the nearest nudge, which lies 0.001 from the reference);
* each time-to-Γ (netsim_tour) equals the reference's where the two
  accuracy traces first reach Γ at the same evaluation; where they do not
  (an accuracy within the control of Γ), the twin's time is None exactly
  when its own trace never reaches Γ.
"""
import dataclasses
import itertools
import json
import os
import runpy
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a torch subprocess runs on one thread, as this process does: the test
# command runs several workers on the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
DIV = 4
GAMMA = 0.9  # netsim_tour's target accuracy
TWINS = ("compare_algorithms", "dynamic_topology", "netsim_tour", "participation_tour")
ACC_KEYS = ("test_acc", "acc", "aware_acc", "fed_chs_acc", "fedavg_acc")
TIME_KEYS = ("fed_chs_t", "fedavg_t")


def _twin(name: str) -> dict:
    return runpy.run_path(os.path.join(ROOT, "examples", f"torch_{name}.py"), run_name="twin")


def start_twin(name: str) -> subprocess.Popen:
    """The twin run in a subprocess on the CPU, started in the background:
    `twin_rows` waits for its rows."""
    code = (f"import json, runpy; m = runpy.run_path({os.path.join(ROOT, 'examples', f'torch_{name}.py')!r}, "
            f"run_name='twin'); print('ROWS', json.dumps(m['main']"
            f"(['--device', 'cpu', '--rounds-div', '{DIV}'])))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **ONE_THREAD)
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env)
    p.started = time.monotonic()
    return p


def twin_rows(p: subprocess.Popen, timeout=600) -> dict:
    """The rows of a started twin, which must end within `timeout` seconds
    of its start (else it is killed and this raises)."""
    try:
        out, err = p.communicate(timeout=max(0.0, p.started + timeout - time.monotonic()))
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, out[-3000:] + err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("ROWS ")][-1]
    return json.loads(line[5:])


# the three 1-ulp nudges of the controls: every entry up, every entry down,
# each entry up or down by a seeded coin
NUDGES = ("up", "down", "coin")


def _nudge(t: torch.Tensor, how: str, gen: torch.Generator) -> torch.Tensor:
    if how == "coin":
        toward = torch.where(torch.rand(t.shape, generator=gen) < 0.5, -np.inf, np.inf)
    else:
        toward = torch.full_like(t, np.inf if how == "up" else -np.inf)
    return torch.nextafter(t, toward.to(t.dtype))


def control_rows(name: str, how: str) -> dict:
    """The twin's rows here, its classifier's weights 1 ulp from the seed's
    (`NUDGES`)."""
    mod = _twin(name)
    make = mod["make_classifier"]

    def make_ulp(*a, **kw):
        clf = make(*a, **kw)

        def init(seed=0, device=None):
            gen = torch.Generator().manual_seed(0)
            return {k: {n: _nudge(t, how, gen) for n, t in v.items()}
                    for k, v in clf.init(seed, device).items()}

        return dataclasses.replace(clf, init=init)

    mod["main"].__globals__["make_classifier"] = make_ulp
    return json.loads(json.dumps(mod["main"](["--device", "cpu", "--rounds-div", str(DIV)])))


# -- the reference's same calls ---------------------------------------------


def _r(n):
    return max(1, n // DIV)


def _ledger(res) -> dict:
    return {"bits": {k: int(v) for k, v in res.ledger.bits.items() if v},
            "messages": {k: int(v) for k, v in res.ledger.messages.items() if v}}


def ref_compare_algorithms() -> dict:
    from repro.comm import TopKChannel
    from repro.core import FedCHSConfig, FLTask, run_fed_chs
    from repro.core.baselines import (FedAvgConfig, HierLocalQSGDConfig, WRWGDConfig,
                                      run_fedavg, run_hier_local_qsgd, run_wrwgd)
    from repro.data import assign_clusters, dirichlet_partition, make_dataset
    from repro.models.classifier import make_classifier

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, ds.spec.num_classes), ds,
                  dirichlet_partition(ds.train_y, 20, 0.3, seed=0), assign_clusters(20, 5, seed=0),
                  batch_size=32, seed=0)
    runs = {
        "Fed-CHS": run_fed_chs(task, FedCHSConfig(rounds=_r(24), local_steps=10,
                                                  eval_every=_r(6))),
        "FedAvg": run_fedavg(task, FedAvgConfig(rounds=_r(6), local_steps=10, eval_every=_r(2))),
        "WRWGD": run_wrwgd(task, WRWGDConfig(rounds=_r(48), local_steps=10, eval_every=_r(12))),
        "Hier-Local-QSGD": run_hier_local_qsgd(
            task, HierLocalQSGDConfig(rounds=_r(4), local_steps=10, local_epochs=5,
                                      eval_every=_r(1))),
        "Fed-CHS (Top-5%)": run_fed_chs(
            task, FedCHSConfig(rounds=_r(24), local_steps=10, local_epochs=5, eval_every=_r(6),
                               channel=TopKChannel(0.05))),
    }
    return {name: {"test_acc": list(res.test_acc), "total_mb": res.ledger.total_megabytes(),
                   **_ledger(res)} for name, res in runs.items()}


def ref_dynamic_topology() -> dict:
    from repro.core import FedCHSConfig, FLTask, run_fed_chs
    from repro.data import assign_clusters, dirichlet_partition, make_dataset
    from repro.models.classifier import make_classifier

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds,
                  dirichlet_partition(ds.train_y, 20, 0.6, seed=0), assign_clusters(20, 5, seed=0),
                  batch_size=32, seed=0)
    settings = {"static sparse": dict(topology="random_sparse", dynamic=None),
                "LEO rotating": dict(dynamic="leo"), "IoV flapping": dict(dynamic="iov")}
    rows = {}
    for name, kw in settings.items():
        res = run_fed_chs(task, FedCHSConfig(rounds=_r(30), local_steps=10, eval_every=_r(10),
                                             seed=0, **kw))
        rows[name] = {"test_acc": list(res.test_acc), "total_mb": res.ledger.total_megabytes(),
                      **_ledger(res)}
    return rows


def ref_netsim_tour() -> dict:
    from repro.core import FedCHSConfig, FLTask, run_fed_chs
    from repro.core.baselines import FedAvgConfig, run_fedavg
    from repro.core.dynamics import make_dynamic
    from repro.core.ledger import dense_message_bits
    from repro.data import assign_clusters, dirichlet_partition, make_dataset
    from repro.models.classifier import make_classifier
    from repro.netsim import edge_cloud_network, simulate_run, time_to_accuracy

    ds = make_dataset("mnist", train_size=3000, test_size=600, seed=0)
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, num_classes=10), ds,
                  dirichlet_partition(ds.train_y, num_clients=20, alpha=0.6, seed=0),
                  assign_clusters(num_clients=20, num_clusters=4, seed=0), batch_size=32, seed=0)
    K, R20, R8 = 10, _r(20), _r(8)
    chs = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1))
    avg = run_fedavg(task, FedAvgConfig(rounds=R8, local_steps=K, eval_every=1))
    rows = {"runs": {"fed_chs_messages": len(chs.ledger.events),
                     "fedavg_messages": len(avg.ledger.events),
                     "fed_chs_acc": list(chs.test_acc), "fedavg_acc": list(avg.test_acc)}}
    nets = {"edge_cloud (paper's sketch)": edge_cloud_network(seed=0),
            "wan_starved (PS 50x slower)": edge_cloud_network(seed=0, wan_mbps=2.0,
                                                              wan_latency_ms=80.0)}
    for name, net in nets.items():
        rows[name] = {
            "fed_chs_t": time_to_accuracy(chs, simulate_run(task, chs, net, local_steps=K), 0.9),
            "fedavg_t": time_to_accuracy(avg, simulate_run(task, avg, net, local_steps=K), 0.9)}
    strag = edge_cloud_network(seed=0, straggler_frac=0.1, heterogeneity=0.3,
                               straggler_slowdown=16.0)
    tl_chs = simulate_run(task, chs, strag, local_steps=K)
    tl_avg = simulate_run(task, avg, strag, local_steps=K)
    rows["stragglers"] = {
        "fed_chs_rounds": [tl_chs.round_duration(t) for t in sorted(tl_chs.round_end)],
        "fedavg_rounds": [tl_avg.round_duration(t) for t in sorted(tl_avg.round_end)]}
    dyn = make_dynamic("iov", task.num_clusters, seed=1)
    chs_dyn = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                             dynamic="iov", topology_seed=1))
    rows["iov"] = {
        "makespan": simulate_run(task, chs_dyn, edge_cloud_network(
            seed=0, backhaul_mbps=20.0, dynamics=dyn), local_steps=K).makespan,
        "clean_makespan": simulate_run(task, chs_dyn, edge_cloud_network(
            seed=0, backhaul_mbps=20.0), local_steps=K).makespan,
        "total_mb": chs_dyn.ledger.total_megabytes(), "acc": list(chs_dyn.test_acc)}
    q = dense_message_bits(task.num_params())
    spread = edge_cloud_network(seed=0, backhaul_mbps=20.0, backhaul_spread=9.0)
    base = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                          topology="full"))
    lat = run_fed_chs(task, FedCHSConfig(rounds=R20, local_steps=K, eval_every=1,
                                         topology="full", link_delay=spread.link_delay_fn(q)))
    rows["latency_aware"] = {
        "makespan": simulate_run(task, base, spread, local_steps=K).makespan,
        "aware_makespan": simulate_run(task, lat, spread, local_steps=K).makespan,
        "acc": list(base.test_acc), "aware_acc": list(lat.test_acc)}
    return rows


def ref_participation_tour() -> dict:
    from repro.core import FedCHSConfig, FLTask, run_fed_chs
    from repro.core.ledger import dense_message_bits
    from repro.data import assign_clusters, dirichlet_partition, make_dataset
    from repro.models.classifier import make_classifier
    from repro.netsim import edge_cloud_network, sgd_step_flops, simulate_run
    from repro.part import AvailabilityAware, GilbertElliottTrace

    ds = make_dataset("mnist", train_size=3000, test_size=800, seed=0)
    task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds,
                  dirichlet_partition(ds.train_y, 15, 0.6, seed=0), assign_clusters(15, 5, seed=0),
                  batch_size=32, seed=0)
    T, K, E, every = _r(30), 8, 2, _r(5)
    sampler = AvailabilityAware(GilbertElliottTrace(p_fail=0.25, p_recover=0.35, seed=5))
    arms = {
        "full participation": FedCHSConfig(rounds=T, local_steps=K, local_epochs=E,
                                           eval_every=every, seed=0),
        "churn": FedCHSConfig(rounds=T, local_steps=K, local_epochs=E, eval_every=every, seed=0,
                              sampler=sampler),
        "churn + availability scheduler": FedCHSConfig(
            rounds=T, local_steps=K, local_epochs=E, eval_every=every, seed=0, sampler=sampler,
            availability_scheduler=True),
    }
    rows, results = {}, {}
    for name, cfg in arms.items():
        res = results[name] = run_fed_chs(task, cfg)
        up = res.ledger.round_bits("client_to_es")
        rows[name] = {"test_acc": list(res.test_acc),
                      "uplink_mb": res.ledger.bits["client_to_es"] / 8e6,
                      "pass_through": len([t for t in range(T) if up.get(t, 0) == 0]),
                      **_ledger(res)}
    net = edge_cloud_network(seed=2, heterogeneity=0.3, straggler_frac=0.25,
                             straggler_slowdown=16.0)
    d, q = task.num_params(), dense_message_bits(task.num_params())
    nominal = net.nominal_chain_s("wireless", q, E * sgd_step_flops(d, task.batch_size))
    no_dl = simulate_run(task, results["churn"], net, local_steps=K)
    with_dl = simulate_run(task, results["churn"], net, local_steps=K, deadline_s=3.0 * nominal)
    rows["netsim"] = {"makespan": no_dl.makespan, "deadline_makespan": with_dl.makespan,
                      "dropped": sum(len(s) for s in with_dl.dropped.values()),
                      "dropped_mb": with_dl.dropped_bits / 8e6}
    return rows


REFERENCE = {"compare_algorithms": ref_compare_algorithms,
             "dynamic_topology": ref_dynamic_topology, "netsim_tour": ref_netsim_tour,
             "participation_tour": ref_participation_tour}


# -- the comparison -----------------------------------------------------------


def _gap(a: list, b: list) -> float:
    """The largest gap between two accuracy traces."""
    assert len(a) == len(b)
    return max((abs(x - y) for x, y in zip(a, b)), default=0.0)


def _first_reach(trace: list) -> int | None:
    return next((i for i, a in enumerate(trace) if a >= GAMMA), None)


def check_time(twin: dict, ref: dict, row: str, key: str) -> str:
    """A time-to-Γ column of netsim_tour: equal to the reference's where
    both accuracy traces of its arm first reach Γ at the same evaluation;
    else None exactly where the twin's trace never reaches Γ."""
    acc = key.removesuffix("_t") + "_acc"
    got, want = twin[row][key], ref[row][key]
    first, ref_first = _first_reach(twin["runs"][acc]), _first_reach(ref["runs"][acc])
    if first == ref_first:
        assert got == want, (row, key, got, want)
        return f"{got} = reference"
    assert (got is None) == (first is None), (row, key, got, first)
    return (f"{got} against the reference's {want}: the traces first reach {GAMMA} at "
            f"evaluations {first} and {ref_first}")


def compare(twin: dict, ref: dict, ctrls: list) -> list:
    """Exact columns equal, time columns by `check_time`; (row, key, gap to
    the reference, 1-ulp control) for every accuracy column, the control
    the largest gap between two of the twin's and the nudged runs'."""
    assert set(ref) <= set(twin), (set(twin), set(ref))
    out = []
    for row, ref_cols in ref.items():
        for key, want in ref_cols.items():
            got = twin[row][key]
            if key in ACC_KEYS:
                runs = [got] + [c[row][key] for c in ctrls]
                out.append((row, key, _gap(got, want),
                            max(_gap(a, b) for a, b in itertools.combinations(runs, 2))))
            elif key in TIME_KEYS:
                print(f"{row} {key}: {check_time(twin, ref, row, key)}")
            elif isinstance(want, float):
                assert got == pytest.approx(want, rel=1e-12, abs=0), (row, key)
            elif isinstance(want, dict):  # per-hop bits or messages; hops never used left out
                assert {k: v for k, v in got.items() if v} == want, (row, key, got, want)
            else:
                assert got == want, (row, key, got, want)
    return out


@pytest.mark.parametrize("name", TWINS)
def test_twin_holds_the_reference_example(name):
    proc = start_twin(name)  # the twin runs beside the reference and the controls here
    try:
        ref = REFERENCE[name]()
        ctrls = [control_rows(name, how) for how in NUDGES]
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    twin = twin_rows(proc)
    for row, key, gap, control in compare(twin, ref, ctrls):
        print(f"{name} {row} {key}: gap {gap:.4g}, 1-ulp control {control:.4g}")
        assert gap <= control, (row, key, gap, control)


# -- the LM twins: weights from the seed alone ----------------------------------
#
# `examples/torch_serve_decode.py` draws the reference example's weights
# (`init_params` from seed 0) and, for an encoder-decoder, its stub frames
# (`jax.random.normal(PRNGKey(1), ...) * 0.1`); nothing is carried across.
# Its greedy tokens equal the reference example's, or the first difference
# comes no earlier than that of the twin against itself from weights 1 ulp
# up (every entry's `nextafter`).

SERVE_ARCHS = ("qwen3-0.6b", "whisper-tiny")


def ref_serve_decode(arch: str, batch: int = 4, prompt_len: int = 16, tokens: int = 32) -> list:
    """`examples/serve_decode.py`'s calls: teacher-forced decode over the
    prompt, then greedy decode."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import smoke_config
    from repro.data.tokens import synthetic_lm_batch
    from repro.models import transformer as jtf

    cfg = smoke_config(arch)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in
         synthetic_lm_batch(cfg.vocab_size, batch, prompt_len, seed=0).items()}
    if cfg.is_encoder_decoder:
        b["frames"] = jax.random.normal(
            jax.random.PRNGKey(1), (batch, cfg.num_audio_frames, cfg.d_model)) * 0.1
    enc_len = cfg.num_audio_frames if cfg.is_encoder_decoder else 0
    caches = jtf.init_caches(cfg, batch, prompt_len + tokens, enc_len=enc_len)
    if cfg.is_encoder_decoder:
        caches = jtf._fill_cross_caches(cfg, params, b, caches)
    step = jax.jit(lambda p, c, t: jtf.decode_step(cfg, p, c, t))
    for t in range(prompt_len):
        logits, caches = step(params, caches, b["tokens"][:, t:t + 1])
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(tokens - 1):
        logits, caches = step(params, caches, tok)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1).tolist()


class _NudgedTransformer:
    """The port's transformer module, its weights 1 ulp up."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def init_params(self, cfg, seed, device):
        from repro_torch.utils import tree_map

        return tree_map(lambda t: torch.nextafter(t, torch.full_like(t, np.inf)),
                        self.module.init_params(cfg, seed, device))


def _first_difference(a: list, b: list):
    """(step, request) of the first token where two generations differ."""
    steps = [i for i in range(len(a[0])) if any(x[i] != y[i] for x, y in zip(a, b))]
    return None if not steps else (steps[0], [r for r in range(len(a)) if a[r][steps[0]] !=
                                               b[r][steps[0]]])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode_twin_holds_the_reference_example(arch):
    argv = ["--arch", arch, "--device", "cpu"]
    twin = _twin("serve_decode")["main"](argv)
    ref = ref_serve_decode(arch)
    first = _first_difference(twin, ref)
    print(f"{arch}: {len(twin)} requests x {len(twin[0])} tokens, first difference from the "
          f"reference's: {first}")
    if first is None:
        return
    mod = _twin("serve_decode")
    mod["main"].__globals__["tf"] = _NudgedTransformer(mod["tf"])
    control = _first_difference(mod["main"](argv), twin)
    print(f"{arch}: the twin's tokens first differ from the reference's at {first}; the "
          f"twin 1 ulp apart first differs at {control}")
    assert control is not None and first[0] >= control[0], (first, control)


# `examples/torch_train_lm_fedchs.py` at its smallest flags (a 2-layer,
# d_model 32 LM over a 64-token vocabulary, 6 rounds of QSGD(16) uplinks)
# against `examples/train_lm_fedchs.py`'s same calls, each drawing its own
# weights from seed 0: the ledger and the visit order exact, the held-out
# perplexities within the 2% of `tests/test_torch_lm.py`'s QSGD runs.

TRAIN_ARGV = ["--d-model", "32", "--layers", "2", "--vocab", "64", "--seq", "16", "--batch",
              "2", "--rounds", "6", "--eval-every", "2", "--target-ppl", "70"]


def ref_train_lm_fedchs():
    """`examples/train_lm_fedchs.py`'s calls at `TRAIN_ARGV` (its toy mode:
    4 clients, 2 clusters, K = 4, E = 2, QSGD(16), lr 0.3)."""
    from repro.comm.channels import QSGDChannel
    from repro.configs.base import ArchConfig
    from repro.core import FedCHSConfig, run_fed_chs
    from repro.core.simulation import FLTask
    from repro.data.sources import TokenSource
    from repro.models.fed import LMFedModel

    cfg = ArchConfig(name="fedchs-lm", family="dense", num_layers=2, d_model=32, num_heads=1,
                     num_kv_heads=1, d_ff=128, vocab_size=64, dtype="float32")
    source = TokenSource(64, 4, 2, 16, topics=4, seed=0)
    task = FLTask.from_source(LMFedModel(cfg), source, [[0, 2], [1, 3]], seed=0)
    return run_fed_chs(task, FedCHSConfig(rounds=6, local_steps=4, local_epochs=2,
                                          eval_every=2, channel=QSGDChannel(16), seed=0,
                                          schedule=lambda k: 0.3))


def test_train_lm_fedchs_twin_holds_the_reference_example():
    res = _twin("train_lm_fedchs")["main"]([*TRAIN_ARGV, "--device", "cpu"])
    jres = ref_train_lm_fedchs()
    assert _ledger(res) == _ledger(jres)  # the hops used; the port's ledger lists every hop
    assert res.ledger.events == jres.ledger.events and res.ledger.history == jres.ledger.history
    assert res.rounds == jres.rounds
    np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.02)
