"""The port's examples (``repro_torch.examples``) on the CPU, against the
reference's ``examples/`` where their numbers are the model's: the
quickstart's co-scheduling profit, the fleet replay's lanes and events
under the TPU v5e model, the straggler shares; and the fault-tolerant run
against a failure-free port run. Each runs with its cwd in the test's tmp
dir, so its checkpoints and stores land there."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import fault_tolerant_training as FT
from repro_torch.examples import multi_tenant_serving as MTS
from repro_torch.examples import quickstart as QS

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "torch_ipc"))
    monkeypatch.setenv("REPRO_IPC_CACHE", str(tmp_path / "ref_ipc"))
    return tmp_path


def _reference_example(name):
    """A module of the reference's ``examples/`` (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu_prints_the_reference_cp(in_tmp, capsys):
    """Quickstart with ``--device cpu``: 10 training steps with a falling
    loss, the sliced matmul equal to the unsliced one, and the C2050 PC+TEA
    profit at 2:2 equal to the reference's, exactly."""
    from repro.core.calibrate import calibrated_benchmarks
    from repro.core.markov import MarkovModel, co_scheduling_profit
    from repro.core.profiles import C2050
    out = QS.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    profs = calibrated_benchmarks(C2050)
    model = MarkovModel(C2050.virtual())
    pc, tea = profs["PC"], profs["TEA"]
    want = co_scheduling_profit(
        (model.single_ipc(pc), model.single_ipc(tea)),
        model.pair_ipc(pc, 2, tea, 2))
    assert out["cp"] == want
    assert out["steps"] == 10 and len(out["losses"]) == 10
    assert out["losses"][-1] < out["losses"][0]
    assert out["err"] == 0.0
    assert [ln.split()[0] for ln in lines] == ["[train]", "[slice]",
                                              "[sched]"]
    assert f"C2050-model predicted CP {want:+.1%}" in lines[2]
    assert (in_tmp / QS.CKPT_DIR / "manifest.json").exists()


def _replay_lines(text):
    """A replay's printed lines without the host time of the replay and
    the model's name on the makespan."""
    text = re.sub(r", replay took [0-9.]+ms", "", text)
    return re.sub(r"\S+-model makespan", "makespan", text).splitlines()


REPLAYS = [dict(n_pods=4), dict(n_pods=1, arrival_rate=1e-5),
           dict(n_pods=1, arrival_rate=1e-5, pods="v5e,v5e-2x"),
           dict(n_pods=2, arrival_rate=1e-5, policy="EDF-KERNELET",
                deal="round_robin")]


@pytest.mark.parametrize("kw", REPLAYS, ids=["fleet4", "arrivals",
                                             "pods", "edf"])
def test_fleet_replay_under_v5e_prints_the_reference_lanes(in_tmp, capsys,
                                                           kw):
    """``fleet_replay`` given the v5e spec and profile function prints the
    reference's lines (lanes, events, waits, engine counts), the replay's
    host time apart."""
    from repro_torch.core.profiles import TPU_V5E, tpu_profile_from_costs
    ref = _reference_example("multi_tenant_serving")
    kw = dict(kw)
    n = kw.pop("n_pods")
    ref.fleet_replay(n, **kw)
    want = _replay_lines(capsys.readouterr().out)
    if "pods" in kw:          # the port's stem is the spec's own name
        kw["pods"] = kw["pods"].replace("v5e", TPU_V5E.name.lower())
    fleet = MTS.fleet_replay(n, spec=TPU_V5E,
                             profile_fn=tpu_profile_from_costs, **kw)
    got = capsys.readouterr().out
    assert "TPUv5e-model makespan" in got
    assert _replay_lines(got) == want
    assert len(fleet.lanes) == (2 if "pods" in kw else n)


def test_fleet_replay_on_the_h100_model(in_tmp, capsys):
    """The default replay plans on the H100 model; ``h100-<k>x`` pods have
    k times its SMs, and an unknown token raises."""
    from repro_torch.core.profiles import H100
    assert MTS._pod_spec("h100") is H100
    two = MTS._pod_spec("h100-2x")
    assert (two.name, two.n_sm) == ("H100-2x", 2 * H100.n_sm)
    for bad in ("v5e", "h100-0x", "a100"):
        with pytest.raises(ValueError):
            MTS._pod_spec(bad)
    fleet = MTS.main(["--pods", "h100,h100-2x", "--arrivals", "1e-5"])
    out = capsys.readouterr().out
    assert "[H100, H100-2x]" in out and "H100-model makespan" in out
    assert [g.name for g in fleet.gpus] == ["H100", "H100-2x"]
    assert fleet.latency["slo_attainment"] >= 0.0


def test_fault_tolerant_training_equals_a_failure_free_run(in_tmp, capsys):
    """Three injected failures (7 twice, 13 once; checkpoints every 5
    steps) end on the failure-free run's weights bit for bit, every rerun
    step repeating its first loss; the straggler shares and makespan are
    the reference's exactly."""
    from repro.runtime.fault_tolerance import StragglerBalancer as RefBal
    from repro_torch.launch.train import train
    os.makedirs(FT.CKPT_DIR)
    # an earlier run's last checkpoint, which a restart must not restore
    np.savez(Path(FT.CKPT_DIR) / "ckpt_00000016.npz")
    Path(FT.CKPT_DIR, "manifest.json").write_text(
        '{"latest_step": 16, "file": "ckpt_00000016.npz"}')
    out = FT.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    free = train("stablelm-3b", use_reduced=True, steps=16, batch=4, seq=64,
                 ckpt_dir=str(in_tmp / "free"), device="cpu")
    res = out["res"]
    assert res["steps"] == 16
    f = free["losses"]
    assert res["losses"] == f[:7] + f[5:7] + f[5:13] + f[10:16]
    for k, v in res["params"].items():
        for (name, a), (_, b) in zip(_leaves(v, k), _leaves(
                free["params"][k], k)):
            assert torch.equal(a, b), name
    bal = RefBal(n_hosts=8, total_slices=256)
    rng = np.random.default_rng(0)
    lat = np.array([1.0] * 7 + [2.5])
    for _ in range(30):
        for h in range(8):
            bal.observe(h, lat[h] * rng.uniform(0.95, 1.05))
    bal.rebalance()
    assert out["shares"] == bal.shares.tolist()
    assert out["makespan"] == bal.makespan()
    assert lines[0].startswith("[ft] survived 3 injected host failures; "
                               "completed 16 steps")
    assert lines[1] == (f"[straggler] step makespan 80.0 -> "
                        f"{bal.makespan():.1f} slice-times after "
                        f"rebalancing (shares: {bal.shares.tolist()})")


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_examples_run_as_modules_and_on_the_card_by_default(in_tmp):
    """``python -m`` runs each example; with no ``--device`` they ask for
    the card, which this machine lacks, and say so."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multi_tenant_serving",
         "--fleet", "2"], capture_output=True, text=True, timeout=120,
        env=env)
    assert res.returncode == 0, res.stderr
    assert "H100-model makespan" in res.stdout
    if torch.cuda.is_available():
        return
    for name in ("quickstart", "fault_tolerant_training"):
        res = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}"],
            capture_output=True, text=True, timeout=120, env=env)
        assert res.returncode != 0 and "no CUDA device" in res.stderr, name
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MTS.main([])
