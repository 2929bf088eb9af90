"""The port's launchers (`repro_torch.launch.serve`, `repro_torch.launch.train`)
run as a user runs them, in subprocesses on the CPU.

* `serve --execute --device cpu`: every request served, the summary line;
* `train --execute --device cpu`: losses and the closing line; resumed
  from a checkpoint of the reference's, each loss within 2e-4 of what
  `repro.launch.train --execute` prints at the same flags (both variants,
  smoke dbrx-132b); a run
  stopped after 3 rounds and resumed from its `--ckpt` prints the losses
  of the uninterrupted run, digit for digit; `--variant hfl` runs;
* either launcher without `--execute` (the production-mesh lowering)
  refuses an arch or shape it cannot lower, non-zero and saying why;
* `examples/torch_serve_decode.py --device cpu` prefills and decodes;
* `serve --federation`: a run killed right after the checkpoint of
  activation 3 (the hidden `--kill-after-activation`) and resumed with
  `--resume` prints the uninterrupted run's JSON summary field for field,
  as `tests/test_resume_parity.py` pins for the reference.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(module, *args, timeout=300, env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    return subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_execute_on_the_cpu():
    r = run("repro_torch.launch.serve", "--arch", "dbrx-132b", "--execute", "--device", "cpu",
            "--requests", "4", "--slots", "2", "--prompt-len", "4", "--max-new", "6")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "arch=dbrx-132b (reduced) | 4 requests over 2 slots | 24 tokens in" in r.stdout
    assert "tok/s" in r.stdout


def losses(out: str) -> dict[int, str]:
    return {int(line.split()[1]): line.split()[3] for line in out.splitlines()
            if line.startswith("round ")}


def test_train_execute_and_resume_on_the_cpu(tmp_path):
    args = ["--arch", "qwen3-0.6b", "--execute", "--device", "cpu", "--batch", "2", "--seq",
            "16", "--ckpt-every", "1"]
    full = run("repro_torch.launch.train", *args, "--rounds", "5")
    assert full.returncode == 0, full.stdout + full.stderr
    assert "done in" in full.stdout and len(losses(full.stdout)) == 5
    ck = str(tmp_path / "ck")
    first = run("repro_torch.launch.train", *args, "--rounds", "3", "--ckpt", ck)
    assert first.returncode == 0, first.stderr
    resumed = run("repro_torch.launch.train", *args, "--rounds", "5", "--ckpt", ck)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from" in resumed.stdout and "at round 3" in resumed.stdout
    assert losses(resumed.stdout) == {t: v for t, v in losses(full.stdout).items() if t >= 3}


# the dbrx cases keep the ids they had before the arch was a parameter
@pytest.mark.parametrize("arch,variant", [
    pytest.param("dbrx-132b", "fedchs", id="fedchs"),
    pytest.param("dbrx-132b", "hfl", id="hfl"),
    pytest.param("recurrentgemma-9b", "fedchs", id="recurrentgemma-9b-fedchs"),
    pytest.param("whisper-tiny", "fedchs", id="whisper-tiny-fedchs"),
    pytest.param("phi-3-vision-4.2b", "hfl", id="phi-3-vision-4.2b-hfl"),
])
def test_train_execute_prints_the_reference_losses(arch, variant, tmp_path):
    """`train --execute` against `python -m repro.launch.train --execute` at
    the same flags.  The two draw their random weights from different
    generators, so both resume from one checkpoint that the reference wrote
    after its round 0 (the port reads the reference's npz format): the same
    rounds, and each printed loss within 2e-4 (one unit of the printed last
    digit, plus the f32 gap).  Whisper's and phi-3-vision's batches carry
    the reference's zero frames and patches."""
    args = ["--arch", arch, "--execute", "--variant", variant, "--batch", "2",
            "--seq", "16"]
    xla = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    ref_ck, our_ck = tmp_path / "ref", tmp_path / "ours"
    first = run("repro.launch.train", *args, "--rounds", "1", "--ckpt", str(ref_ck), env=xla)
    assert first.returncode == 0, first.stdout + first.stderr
    shutil.copytree(ref_ck, our_ck)
    ref = run("repro.launch.train", *args, "--rounds", "4", "--ckpt", str(ref_ck), env=xla)
    ours = run("repro_torch.launch.train", *args, "--rounds", "4", "--ckpt", str(our_ck),
               "--device", "cpu")
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert ours.returncode == 0, ours.stdout + ours.stderr
    assert "resumed from" in ours.stdout and "at round 1" in ours.stdout
    got, want = losses(ours.stdout), losses(ref.stdout)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for t in want:
        assert abs(float(got[t]) - float(want[t])) <= 2e-4, (t, got[t], want[t])


def test_train_execute_hfl_variant_on_the_cpu():
    r = run("repro_torch.launch.train", "--arch", "dbrx-132b", "--execute", "--device", "cpu",
            "--variant", "hfl", "--rounds", "2", "--batch", "2", "--seq", "16")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "variant=hfl" in r.stdout and len(losses(r.stdout)) == 2


def test_lowering_modes_exit_nonzero():
    """The lowering mode (no --execute) refuses what it cannot lower before
    it builds anything: a full-attention arch at long_500k, an unknown
    arch.  (Lowering itself: tests/test_torch_dryrun.py.)"""
    r = run("repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--shape", "long_500k")
    assert r.returncode != 0 and "does not support long_500k" in r.stderr
    r = run("repro_torch.launch.train", "--arch", "no-such-arch")
    assert r.returncode != 0 and "unknown arch" in r.stderr


def service(*extra):
    return run("repro_torch.launch.serve", "--federation", "--device", "cpu", "--rounds", "6",
               "--clients", "8", "--clusters", "2", "--local-steps", "2", "--quorum-frac",
               "0.6", "--deadline-s", "2.0", "--churn-p", "0.75", "--seed", "0", *extra,
               timeout=600)


def test_federation_service_kill_and_resume(tmp_path):
    full = service()
    assert full.returncode == 0, full.stderr
    ck = str(tmp_path / "ck")
    killed = service("--checkpoint", ck, "--kill-after-activation", "3")
    assert killed.returncode == 1 and "killed after activation 3" in killed.stdout
    resumed = service("--checkpoint", ck, "--resume")
    assert resumed.returncode == 0, resumed.stderr
    a = json.loads(full.stdout.strip().splitlines()[-1])
    b = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert a["algo"] and a["total_bits"] > 0 and len(a["sim_times"]) == len(a["test_acc"])
    for k in ("test_acc", "sim_times", "total_bits", "staleness", "rounds"):
        assert a[k] == b[k], f"{k}: {a[k]} != {b[k]}"


def test_serve_decode_example_on_the_cpu():
    """`examples/torch_serve_decode.py`: a batch prefilled and decoded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_decode.py"),
                        "--arch", "dbrx-132b", "--device", "cpu", "--tokens", "6"], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "arch=dbrx-132b (reduced) | 4 requests | prompt 16 | generated 6" in r.stdout
    assert r.stdout.count("request ") == 2
