"""The port's entry points on all of a host's devices: ``torchrun`` starts
one process a device, and ``launch/train.py`` and ``launch/serve.py`` make
the process group from its variables (``launch/mesh.py::init_from_env``),
here gloo ranks on the CPU.  Each run is held against the same command in
one process.  Every subprocess starts when the module does and has its own
time limit.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jax.sharding import AbstractMesh

ROOT = Path(__file__).resolve().parents[1]
TASKS = Path(__file__).resolve().parent / "_torch_dryrun_tasks.py"
sys.path.insert(0, str(TASKS.parent))
from test_torch_dryrun_mesh import _jax_bytes  # noqa: E402

TIMEOUT = 240
TRAIN = ["-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
         "--global-batch", "4", "--seq-len", "32"]
SERVE = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         "granite-moe-1b-a400m"]


def _torchrun(n: int):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (return code, stdout, stderr) of each command, all started
    together; "bytes_2x2" -> the dry run's per-device bytes on a fake
    (2, 2) group."""
    d = tmp_path_factory.mktemp("launch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    cards = torch.cuda.device_count()
    over = dict(env, RANK="0", WORLD_SIZE=str(cards + 1), LOCAL_RANK="0",
                LOCAL_WORLD_SIZE=str(cards + 1))
    commands = {
        "train4": (_torchrun(4) + TRAIN + ["--model-axis", "2"], env),
        "train1": ([sys.executable] + TRAIN + ["--loader-workers", "1"], env),
        "serve2": (_torchrun(2) + SERVE, env),
        "serve1": ([sys.executable] + SERVE, env),
        "over": ([sys.executable, "-m", "repro_torch.launch.train",
                  "--steps", "1"], over),
        "bytes_2x2": ([sys.executable, str(TASKS), "bytes_2x2",
                       str(d / "bytes_2x2.json")], env),
    }
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=e, cwd=d)
             for name, (cmd, e) in commands.items()}
    out = {}
    try:
        for name, p in procs.items():
            try:
                so, se = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
            out[name] = (p.returncode, so, se[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if out["bytes_2x2"][0] == 0:
        out["bytes_2x2"] = json.loads((d / "bytes_2x2.json").read_text())
    return out


def _ok(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, (name, so, se)
    return so


def test_torchrun_trains_on_a_2x2_mesh_as_one_process(runs):
    """Four gloo ranks with --model-axis 2 train on (2, 2); only rank 0
    prints, and the final loss is the one-process CLI's to 1e-5 (that one
    with the single loader worker each rank uses, so that its batches are
    theirs)."""
    four, one = _ok(runs, "train4"), _ok(runs, "train1")
    done = [ln for ln in four.splitlines() if ln.startswith("done:")]
    assert len(done) == 1, four
    assert done[0].endswith("mesh=(2, 2)")
    assert len(re.findall(r"^step ", four, re.M)) == 1
    loss = lambda s: float(re.search(r"final_loss=([0-9.]+)", s).group(1))
    assert "mesh=" not in one
    assert abs(loss(four) - loss(one)) <= 1e-5 * abs(loss(one))


def test_torchrun_serves_on_two_ranks_the_tokens_of_one(runs):
    """Two gloo ranks serve granite on (2, 1), printing once the greedy ids
    one process prints."""
    two, one = _ok(runs, "serve2"), _ok(runs, "serve1")
    ids = lambda s: [ln for ln in s.splitlines() if ln.startswith("sample")]
    assert len(ids(two)) == 1 and ids(two) == ids(one), (two, one)
    assert "mesh (2, 1)" in two and "mesh" not in one


def test_a_world_larger_than_the_cards_raises(runs):
    rc, _, err = runs["over"]
    assert rc != 0
    assert "CUDA devices visible" in err, err


def test_fake_2x2_mesh_counts_jax_shard_bytes(runs):
    """``make_fake_mesh(shape=(2, 2))``: every cell's per-device bytes of
    state, cache and inputs equal JAX's ``shard_shape`` on an abstract
    (2, 2) mesh."""
    got = runs["bytes_2x2"]
    assert isinstance(got, dict), got
    amesh = AbstractMesh((2, 2), ("data", "model"))
    assert len(got) == 33
    for cell, port in got.items():
        arch, shape = cell.split("/")
        assert port == _jax_bytes(arch, shape, amesh), cell
