"""The LMs' initial weights: one seed gives the reference's LM.

* `init_params(cfg, seed, "cpu")` of every registered config (smoke size,
  seeds 0 and 1, and bf16 at seed 3) is bit-equal, leaf for leaf, to the
  reference's `init_params(cfg, PRNGKey(seed))`;
* the plain draw `kernels/ref.py::normal_ref` (what `init_params` runs on
  the CPU, what `core/prng.py::normal` draws for the classifiers, and what
  the card's `normal_fill` kernel is held to) equals `jax.random.normal`
  bit for bit over odd sizes, nonzero offsets and offsets past 2^32 (there
  against jax's own threefry of the 64-bit counters and jax's steps after
  the bits), scaled and rounded to bf16;
* `prng.uniform` = `jax.random.uniform`; the MoE experts' f32 scales and
  `dense_init`'s f64 ones as the reference computes them; SSD's `A_log`
  (XLA's f32 linspace and log) for H from 2 to 352 and every config's H;
* whole Fed-CHS runs of the smoke qwen3-0.6b LM started from the seed alone
  on both sides (no weights carried across): ledgers and visit order
  exact, perplexities and params within the bounds of
  `tests/test_torch_lm.py`'s toy-LM runs;
* `normal_fill` on the CPU: its plain version, nothing drawn into a fake
  tensor, and the dtypes it refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.comm.channels import DenseChannel as JaxDenseChannel
from repro.comm.channels import QSGDChannel as JaxQSGDChannel
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import FedCHSConfig as JaxConfig
from repro.core import run_fed_chs as jax_run_fed_chs
from repro.core.simulation import FLTask as JaxFLTask
from repro.data.sources import TokenSource as JaxTokenSource
from repro.models import ssd as jssd
from repro.models import transformer as jtf
from repro.models.fed import LMFedModel as JaxLMFedModel
from repro_torch.checkpoint.io import treedef_str
from repro_torch.comm.channels import DenseChannel, QSGDChannel
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.core import FedCHSConfig, FLTask, prng, run_fed_chs
from repro_torch.data.sources import TokenSource
from repro_torch.kernels import ref
from repro_torch.kernels.normal import normal_fill
from repro_torch.models import LMFedModel
from repro_torch.models import ssd
from repro_torch.models import transformer as tf
from repro_torch.utils import tree_leaves

torch.set_num_threads(1)


def bits_of(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns (bf16 as int16)."""
    t = t.detach().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy().view(np.int32)


def jbits_of(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


# ---------------------------------------------------------------------------
# init_params, bit for bit
# ---------------------------------------------------------------------------

CASES = [(arch, seed, "float32") for arch in ARCH_IDS for seed in (0, 1)] + \
        [(arch, 3, "bfloat16") for arch in ARCH_IDS]


@pytest.mark.parametrize("arch,seed,dtype", CASES,
                         ids=[f"{a}-seed{s}-{d}" for a, s, d in CASES])
def test_init_params_equal_reference(arch, seed, dtype):
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype)
                 for c in (jax_smoke_config(arch), smoke_config(arch)))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    p = tf.init_params(cfg, seed, "cpu")
    assert treedef_str(p) == str(jax.tree.structure(jp))
    for i, (a, t) in enumerate(zip(jax.tree.leaves(jp), tree_leaves(p))):
        assert tuple(t.shape) == a.shape and str(t.dtype).removeprefix("torch.") == \
            str(a.dtype), i
        np.testing.assert_array_equal(bits_of(t), jbits_of(a), err_msg=f"leaf {i}")


def test_init_params_draws_the_stacked_repetitions_apart():
    """A superblock's repetition r is drawn under its own key: repetition 1
    of a 2-layer stack equals a tail block drawn under keys[1]."""
    cfg = smoke_config("qwen3-0.6b")
    p = tf.init_params(cfg, 5, "cpu")
    keys = prng.split(prng.PRNGKey(5), cfg.num_layers + cfg.encoder_layers + 8)
    one = tf.init_block(cfg, "attn", keys[1], tf._dtype(cfg), "cpu")
    for a, b in zip(tree_leaves(p["super"][0]), tree_leaves(one)):
        assert torch.equal(a[1], b)
    assert not torch.equal(p["super"][0]["attn"]["wq"][0], p["super"][0]["attn"]["wq"][1])


# ---------------------------------------------------------------------------
# the plain draw
# ---------------------------------------------------------------------------

KEY = prng.split(prng.PRNGKey(11), 3)[2]


@pytest.mark.parametrize("n", [1, 7, 1000, 70001, (1 << 18) + 3])
def test_normal_ref_equals_jax(n):
    want = np.asarray(jax.random.normal(jnp.asarray(KEY), (n,), jnp.float32))
    np.testing.assert_array_equal(bits_of(ref.normal_ref(KEY, 0, n, 1.0)),
                                  want.view(np.int32))
    np.testing.assert_array_equal(prng.normal(KEY, (n,)).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("offset,n", [(1, 6), (999, 1001), (65535, 70001)])
def test_normal_ref_window_equals_jax(offset, n):
    want = np.asarray(jax.random.normal(jnp.asarray(KEY), (offset + n,), jnp.float32))[offset:]
    np.testing.assert_array_equal(bits_of(ref.normal_ref(KEY, offset, n, 1.0)),
                                  want.view(np.int32))


def _jax_threefry_bits(key, offset: int, n: int) -> np.ndarray:
    """jax's threefry of the 64-bit counters [offset, offset + n) (high
    word, low word), the two output words xor'ed."""
    idx = np.arange(offset, offset + n, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
    out = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key), jnp.concatenate(
        [jnp.asarray(hi), jnp.asarray(lo)])))
    return out[:n] ^ out[n:]


@jax.jit
def _jax_normal_of_bits(bits):
    """`jax.random.normal`'s steps after its random bits (`_uniform` on
    (nextafter(-1, 0), 1), then sqrt(2) erf_inv), in the same lax ops."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    floats = jax.lax.bitcast_convert_type(
        jax.lax.shift_right_logical(bits, np.uint32(9)) | np.uint32(0x3F800000),
        jnp.float32) - np.float32(1)
    u = jax.lax.max(lo, floats * (np.float32(1) - lo) + lo)
    return jax.lax.mul(np.float32(np.sqrt(2)), jax.lax.erf_inv(u))


@pytest.mark.parametrize("offset", [0, (1 << 32) - 5, 3 << 32, (1 << 40) + 12345])
def test_normal_ref_past_the_32_bit_index(offset):
    """Entries whose flat index has a nonzero high word: their bits are
    jax's threefry of the (high, low) counter words, and their values
    jax's steps after the bits, which offset 0 holds to
    `jax.random.normal` itself."""
    n = 37 if offset else 70001
    want_bits = _jax_threefry_bits(KEY, offset, n)
    got_bits = ref._threefry_bits(ref._Host, int(KEY[0]), int(KEY[1]), offset, n)
    np.testing.assert_array_equal(got_bits.astype(np.uint32), want_bits)
    want = np.asarray(_jax_normal_of_bits(jnp.asarray(want_bits)))
    if not offset:
        np.testing.assert_array_equal(want.view(np.int32), np.asarray(jax.random.normal(
            jnp.asarray(KEY), (n,), jnp.float32)).view(np.int32))
    np.testing.assert_array_equal(bits_of(ref.normal_ref(KEY, offset, n, 1.0)),
                                  want.view(np.int32))


@pytest.mark.parametrize("scale", [0.02, 1.0 / np.sqrt(1024), 0.2])
def test_normal_ref_scaled_and_rounded_as_the_reference(scale):
    """`normal * scale` in f32, then `.astype(bf16)` (round to nearest
    even), as `dense_init` does."""
    n = 5001
    base = jax.random.normal(jnp.asarray(KEY), (n,), jnp.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = (base * np.float32(scale)).astype(jdtype)
        got = ref.normal_ref(KEY, 0, n, scale, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(bits_of(got), jbits_of(want))


@pytest.mark.parametrize("offset,n", [
    (0, 2 * ref._NORMAL_CHUNK + 3),  # two chunk boundaries
    ((1 << 32) - ref._NORMAL_CHUNK // 2, ref._NORMAL_CHUNK + 5),  # into the high word 1
    ((3 << 32) + 12345, ref._NORMAL_CHUNK + 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_ref_bits_do_not_depend_on_the_thread_count(offset, n, dtype):
    """The plain draw gives the same bits at one torch thread and at eight,
    across chunk boundaries and past flat index 2^32."""
    before = torch.get_num_threads()
    try:
        draws = []
        for threads in (1, 8):
            torch.set_num_threads(threads)
            draws.append(bits_of(ref.normal_ref(KEY, offset, n, 0.02, dtype)))
    finally:
        torch.set_num_threads(before)
    np.testing.assert_array_equal(draws[0], draws[1])


def test_uniform_equals_jax():
    for seed, shape, lo, hi in ((0, (7,), 0.3, 0.8), (4, (2560,), 0.3, 0.8),
                                (9, (3, 50), -1.0, 2.5), (2, (1000,), 0.0, 1.0)):
        key = prng.split(prng.PRNGKey(seed), 6)[4]
        want = np.asarray(jax.random.uniform(jnp.asarray(key), shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(prng.uniform(key, shape, lo, hi), want)


# ---------------------------------------------------------------------------
# scales and deterministic leaves
# ---------------------------------------------------------------------------

def _widths() -> set:
    out = set()
    for arch in ARCH_IDS:
        for c in (get_config(arch), smoke_config(arch)):
            out |= {c.d_model, c.d_ff, c.lru_width or c.d_model}
    return {w for w in out if w}


def test_moe_scales_in_f32_and_dense_scales_in_f64():
    """The experts' 1 / sqrt(n) is computed in f32 (`init_moe`), the dense
    layers' in f64 and rounded once (`dense_init`), at every width of the
    registry; the two differ by 1 ulp at about a quarter of all widths (6
    and 7 the first), so each leaf takes the reference's own."""
    for n in sorted(_widths()):
        assert np.float32(1) / np.sqrt(np.float32(n)) == np.asarray(1.0 / jnp.sqrt(n)), n
        assert np.float32(1.0 / np.sqrt(n)) == \
            np.asarray(jnp.ones((), jnp.float32) * (1.0 / np.sqrt(n))), n
    assert np.float32(1) / np.sqrt(np.float32(6)) != np.float32(1.0 / np.sqrt(6))
    assert [a for a in ARCH_IDS if get_config(a).is_moe] == ["dbrx-132b", "deepseek-v3-671b"]


@pytest.mark.parametrize("H", list(range(2, 353)))
def test_linspace_and_log_equal_xla(H):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H)))
    np.testing.assert_array_equal(prng.log(prng.linspace(1.0, 16.0, H)), want)


def test_a_log_of_every_ssd_config():
    """`init_ssd_block`'s `A_log` against the reference's block at each SSD
    smoke config; each whole config's H lies in the range that
    `test_linspace_and_log_equal_xla` holds."""
    held = []
    for arch in ARCH_IDS:
        if "ssd" not in get_config(arch).block_pattern:
            continue
        want = jssd.init_ssd_block(jax_smoke_config(arch), jax.random.PRNGKey(0), jnp.float32)
        got = ssd.init_ssd_block(smoke_config(arch), prng.PRNGKey(0), torch.float32, "cpu")
        np.testing.assert_array_equal(got["A_log"].numpy(), np.asarray(want["A_log"]))
        held.append(ssd._dims(get_config(arch))[2])
    assert held and all(2 <= H <= 352 for H in held)


# ---------------------------------------------------------------------------
# whole runs from the seed alone
# ---------------------------------------------------------------------------

ARCH = "qwen3-0.6b"
CLUSTERS = [[0, 1], [2, 3]]


@pytest.fixture(scope="module")
def seed_tasks():
    def source(module):
        return module(smoke_config(ARCH).vocab_size, num_clients=4, batch_size=2, seq_len=16,
                      topics=4, seed=0)

    jtask = JaxFLTask.from_source(JaxLMFedModel(jax_smoke_config(ARCH)), source(JaxTokenSource),
                                  CLUSTERS, seed=0)
    task = FLTask.from_source(LMFedModel(smoke_config(ARCH)), source(TokenSource), CLUSTERS,
                              seed=0, device="cpu")
    return jtask, task


def flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(a).ravel() for a in leaves])


@pytest.mark.parametrize("wire", ["qsgd16", "dense"])
def test_fed_chs_run_from_the_seed_matches_reference(seed_tasks, wire):
    """Both packages draw their own initial weights from seed 0 (bit-equal),
    then run as the smoke-LM runs of `tests/test_torch_{ssd,mla,rglru}.py`
    run from carried weights (2 rounds, K = 2, E = 2 under QSGD), held as
    they are: ledgers and visit order exact; QSGD perplexities at rtol 0.02
    and the params' gap under 3% of the update; grad mode (dense) at rtol
    1e-5 and 3e-5 of |p_T|."""
    jtask, task = seed_tasks
    p0 = flat(tree_leaves(task.init_params()))
    np.testing.assert_array_equal(p0, flat(jax.tree.leaves(jtask.init_params())))
    if wire == "qsgd16":
        channel, jchannel, kw = QSGDChannel(16), JaxQSGDChannel(16), dict(local_epochs=2)
    else:
        channel, jchannel, kw = DenseChannel(), JaxDenseChannel(), {}
    common = dict(rounds=2, local_steps=2, eval_every=1, seed=0, schedule=lambda k: 0.3, **kw)
    jres = jax_run_fed_chs(jtask, JaxConfig(channel=jchannel, **common))
    res = run_fed_chs(task, FedCHSConfig(channel=channel, **common))
    jl, tl = jres.ledger, res.ledger
    assert dict(tl.bits) == dict(jl.bits) and dict(tl.messages) == dict(jl.messages)
    assert tl.history == jl.history and tl.events == jl.events
    assert [e.sender for e in tl.events if e.hop == "es_to_es"] == \
        [e.sender for e in jl.events if e.hop == "es_to_es"]
    assert res.rounds == jres.rounds
    got, want = flat(tree_leaves(res.final_params)), flat(jax.tree.leaves(jres.final_params))
    if wire == "qsgd16":
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=0.02)
        assert np.linalg.norm(got - want) <= 0.03 * np.linalg.norm(want - p0)
    else:
        np.testing.assert_allclose(res.test_acc, jres.test_acc, rtol=1e-5)
        np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-5)
        assert np.linalg.norm(got - want) <= 3e-5 * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

def test_normal_fill_on_the_cpu_is_its_plain_version():
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.empty((3, 41, 5), dtype=dtype)
        assert normal_fill(out, KEY, 0.5, offset=17) is out
        assert torch.equal(out.reshape(-1), ref.normal_ref(KEY, 17, out.numel(), 0.5, dtype))


def test_normal_fill_draws_nothing_into_a_fake_tensor_and_refuses_other_dtypes():
    with FakeTensorMode():
        fake = torch.empty((1 << 20, 1 << 12), dtype=torch.bfloat16)
        assert normal_fill(fake, KEY, 1.0) is fake
    with pytest.raises(ValueError):
        normal_fill(torch.empty(4, dtype=torch.float16), KEY, 1.0)
    with pytest.raises(ValueError):
        normal_fill(torch.empty((4, 4)).t(), KEY, 1.0)
