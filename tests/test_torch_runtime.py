"""The port's ``runtime/`` (serving daemon, pod fleet, chaos harness,
``ResilientLoop``) against the reference's: the same seeded scenarios,
taken from tests/test_daemon_recovery.py, tests/test_pod_fleet.py and
tests/test_fleet_hetero.py's specs, run through ``repro.runtime`` and
``repro_torch.runtime`` and give the same job states, results and chaos
outcomes. Then the port's ``SharedPodServer.drain`` under the port's own
``ServingDaemon``: pause, cancel, and a stolen lease. numpy-only, with
every artifact store off."""
import dataclasses
import importlib
import time

import pytest

from repro_torch.core.profiles import H100
from repro_torch.launch import serve as TS

PKGS = ("repro", "repro_torch")

# tests/test_daemon_recovery.py:28-40
PROFILES = {
    "A": dict(name="A", rm=0.05, coal=1.0, insns_per_block=50.0,
              num_blocks=32, occupancy=1.0),
    "B": dict(name="B", rm=0.4, coal=0.5, insns_per_block=70.0,
              num_blocks=32, occupancy=1.0),
    "C": dict(name="C", rm=0.15, coal=0.9, insns_per_block=90.0,
              num_blocks=48, occupancy=1.0),
    "D": dict(name="D", rm=0.6, coal=0.4, insns_per_block=40.0,
              num_blocks=24, occupancy=0.75),
}
ORDER = ["A", "B", "C", "D", "B", "A", "D", "C", "A", "B", "C", "D"]


def _spec(policy="KERNELET", gpu="C2050", **kw):
    return dict({"policy": policy, "profiles": PROFILES, "order": ORDER,
                 "gpu": gpu, "rounds": 600, "persist": False, "seed": 3},
                **kw)


def _mods(pkg):
    return {m: importlib.import_module(f"{pkg}.{m}") for m in
            ("core.jobstore", "runtime.chaos", "runtime.daemon",
             "runtime.fault_tolerance")}


@pytest.fixture(autouse=True)
def _no_cache(monkeypatch):
    monkeypatch.setenv("REPRO_IPC_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", "0")


# ---- the scenarios, each returning what the two packages must share ---- #
def _recovery(pkg, tmp):
    """tests/test_daemon_recovery.py:152-178: three HostFailures injected
    at checkpoints, capped exponential backoff, against a fault-free run."""
    m = _mods(pkg)
    Daemon = m["runtime.daemon"].ServingDaemon
    clean = Daemon(str(tmp / f"{pkg}-ref.sqlite"))
    clean.submit("j", _spec("MC"))
    clean_states = clean.run_until_idle()
    faults, sleeps = {"left": 3}, []

    def chaos(daemon, job_id, phase):
        if faults["left"] > 0:
            faults["left"] -= 1
            raise m["runtime.fault_tolerance"].HostFailure(f"at {phase}")

    d = Daemon(str(tmp / f"{pkg}-pod.sqlite"), on_checkpoint=chaos,
               max_retries=5, backoff_base=0.01, backoff_cap=0.02,
               sleep=sleeps.append)
    d.submit("j", _spec("MC"))
    states = d.run_until_idle()
    out = dict(clean_states=clean_states, states=states, sleeps=sleeps,
               clean=clean.store.result("j"), result=d.store.result("j"),
               edges=[(e[2], e[3]) for e in d.store.events("j")])
    clean.close()
    d.close()
    return out


def _stolen_lease(pkg, tmp):
    """tests/test_pod_fleet.py:384-410: the victim's lease is requeued
    under a skewed clock mid-drain, a thief finishes the job, and the
    victim's next fenced write becomes a counted ``lost``."""
    m = _mods(pkg)
    Daemon = m["runtime.daemon"].ServingDaemon
    path = str(tmp / f"{pkg}-zombie.sqlite")
    victim = Daemon(path, pod_id="victim", ckpt_every=1)
    thief = Daemon(path, pod_id="thief", ckpt_every=1)
    victim.submit("j0", _spec(alpha_p=0.4, alpha_m=0.1, table_seed=0))
    stolen = []

    def steal_once(daemon, job_id, phase):
        if stolen:
            return
        assert daemon.store.requeue_expired(now=time.time() + 1e6)
        stolen.append(thief.serve_once())

    victim.on_checkpoint = steal_once
    out = dict(victim=victim.serve_once(), thief=stolen,
               lost=victim.stats()["lost"],
               finished=thief.stats()["finished"],
               result=victim.store.result("j0"))
    m["runtime.chaos"].finished_exactly_once(victim.store, ["j0"])
    victim.close()
    thief.close()
    return out


def _chaos(pkg, tmp):
    """tests/test_pod_fleet.py:431-443, seed 0: three pods under a seeded
    kill, store-fault and clock-skew schedule, every job finished exactly
    once and bit-identical to one uninterrupted pod (asserted inside)."""
    summary = _mods(pkg)["runtime.chaos"].run_scenario(
        0, n_pods=3, workdir=str(tmp), verbose=False)
    return dict(idle=summary["idle"], jobs=summary["jobs"],
                results=summary["results"])


def _resilient_loop(pkg, tmp):
    """tests/test_daemon_recovery.py:305-323: ``ResilientLoop`` on the job
    store's checkpoints, HostFailures at steps 7 and 13."""
    m = _mods(pkg)
    store = m["core.jobstore"].JobStore(str(tmp / f"{pkg}-train.sqlite"))
    store.create_job("train", {})
    ckpts = m["runtime.daemon"].JobStoreCheckpoints(store)

    class Loader:
        def load(self, step):
            return float(step)

    def step_fn(state, batch):
        return {"acc": state["acc"] + batch * 1.5,
                "steps": state["steps"] + 1}, {}

    loop = m["runtime.fault_tolerance"].ResilientLoop(
        step_fn, {"acc": 0.0, "steps": 0}, Loader(), "train", ckpt_every=4,
        max_retries=3, store=ckpts)
    state, step = loop.run(21, fail_at={7: 1, 13: 2})
    out = dict(state=state, step=step, latest=ckpts.latest_step("train"))
    store.close()
    return out


def _hetero_specs(pkg, tmp):
    """tests/test_fleet_hetero.py:41-43's mixed pods as daemon jobs: the
    same profiles on C2050, on a C2050 of twice and of half its SMs (each
    as a GPUSpec field dict) and on GTX680, every job arrival-timed."""
    m = _mods(pkg)
    c2050 = dataclasses.asdict(m["runtime.daemon"].resolve_gpu("C2050"))
    gpus = {"c2050": "C2050", "gtx680": "GTX680",
            "fast": dict(c2050, name="C2050-2x", n_sm=28),
            "slow": dict(c2050, name="C2050-half", n_sm=7)}
    d = m["runtime.daemon"].ServingDaemon(str(tmp / f"{pkg}-hetero.sqlite"))
    arrivals = [i * 5e4 for i in range(len(ORDER))]
    for name, gpu in gpus.items():
        d.submit(name, _spec("EDF-KERNELET", gpu=gpu, rounds=400,
                             arrivals=arrivals, slo_deadline=2.0e6))
    out = dict(states=d.run_until_idle(),
               results={name: d.store.result(name) for name in gpus})
    d.close()
    return out


SCENARIOS = {"recovery": _recovery, "stolen_lease": _stolen_lease,
             "chaos": _chaos, "resilient_loop": _resilient_loop,
             "hetero_specs": _hetero_specs}


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Every scenario once through each package, run on demand."""
    done = {}

    def get(pkg, name):
        if (pkg, name) not in done:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_IPC_CACHE", "0")
                mp.setenv("REPRO_TORCH_IPC_CACHE", "0")
                done[pkg, name] = SCENARIOS[name](
                    pkg, tmp_path_factory.mktemp(f"{pkg}-{name}"))
        return done[pkg, name]
    return get


@pytest.mark.parametrize("pkg", PKGS)
def test_daemon_resumes_after_host_failures(outcomes, pkg):
    out = outcomes(pkg, "recovery")
    assert out["clean_states"] == out["states"] == {"j": "finished"}
    assert out["result"]["total_cycles"] == out["clean"]["total_cycles"]
    assert out["result"]["time_line"] == out["clean"]["time_line"]
    assert out["sleeps"] == [0.01, 0.02, 0.02]


@pytest.mark.parametrize("pkg", PKGS)
def test_stolen_lease_is_lost_once_and_finished_once(outcomes, pkg):
    out = outcomes(pkg, "stolen_lease")
    assert out["victim"] == ("j0", "lost")
    assert out["thief"] == [("j0", "finished")]
    assert (out["lost"], out["finished"]) == (1, 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_chaos_fleet_finishes_every_job_once(outcomes, pkg):
    out = outcomes(pkg, "chaos")
    assert out["idle"] and set(out["jobs"].values()) == {"finished"}


@pytest.mark.parametrize("pkg", PKGS)
def test_resilient_loop_resumes_on_the_job_store(outcomes, pkg):
    out = outcomes(pkg, "resilient_loop")
    assert out["step"] == out["latest"] == 21
    assert out["state"] == {"acc": 1.5 * sum(range(21)), "steps": 21}


@pytest.mark.parametrize("pkg", PKGS)
def test_mixed_pod_specs_each_drain(outcomes, pkg):
    out = outcomes(pkg, "hetero_specs")
    assert set(out["states"].values()) == {"finished"}
    cycles = {n: r["total_cycles"] for n, r in out["results"].items()}
    assert cycles["fast"] < cycles["c2050"] < cycles["slow"], cycles


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_runtime_equals_reference(outcomes, name):
    """The same seeded scenario gives the same job states, results and
    chaos outcomes in both packages, bit for bit."""
    assert outcomes("repro_torch", name) == outcomes("repro", name)


def test_port_daemon_plans_on_its_own_chip(tmp_path):
    """The port's daemon resolves ``"H100"``, which the reference's does
    not know, and drains a job planned on it."""
    from repro.runtime import daemon as JD
    from repro_torch.runtime import daemon as TD
    assert TD.resolve_gpu("H100") is H100
    with pytest.raises(ValueError, match="unknown GPU"):
        JD.resolve_gpu("H100")
    d = TD.ServingDaemon(str(tmp_path / "pod.sqlite"))
    d.submit("j", _spec(gpu="H100", rounds=300))
    assert d.run_until_idle() == {"j": "finished"}
    assert d.store.result("j")["total_cycles"] > 0
    d.close()


# ---- the port's drain under the port's own daemon ---- #
JOBS = [("a-prefill", "phi3-mini-3.8b", "prefill", 6, 1, 32),
        ("b-decode", "starcoder2-15b", "decode", 6, 1, 32)]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path_factory.mktemp("p")))
        srv = TS.SharedPodServer(device="cpu")
        for job in JOBS:
            srv.submit(TS.Job(*job))
        yield srv


def _drain(srv, dmn, hook):
    """Reset the slices, then drain with ``hook`` run before the first
    prefill slice."""
    for name, *_, n, _b, _s in JOBS:
        srv.jobs[name].num_slices = n
    orig = srv._exec["a-prefill"]
    calls = []

    def hooked():
        calls.append(1)
        if len(calls) == 1:
            hook()
        return orig()

    srv._exec["a-prefill"] = hooked
    try:
        return srv.drain(daemon=dmn, plan_first=False)
    finally:
        srv._exec["a-prefill"] = orig


@pytest.fixture
def daemon(tmp_path):
    from repro_torch.runtime.daemon import ServingDaemon
    d = ServingDaemon(str(tmp_path / "serve.sqlite"), pod_id="server-pod")
    yield d
    d.close()


def test_drain_pauses_and_resumes_under_the_port_daemon(server, daemon):
    from repro_torch.core.jobstore import FINISHED, PAUSED
    res = _drain(server, daemon, lambda: daemon.pause("serve-drain"))
    assert res["state"] == PAUSED
    remaining = {n: j.num_slices for n, j in server.jobs.items()}
    assert any(remaining.values())
    _, ck = daemon.store.load_checkpoint("serve-drain")
    assert ck["pending"] == {n: v for n, v in remaining.items() if v}
    res = server.drain(daemon=daemon, plan_first=False)
    assert res["state"] == FINISHED
    assert all(j.num_slices == 0 for j in server.jobs.values())
    assert daemon.store.lease_of("serve-drain")[:2] == ("", 2)


def test_drain_cancels_under_the_port_daemon(server, daemon):
    from repro_torch.core.jobstore import CANCELLED
    res = _drain(server, daemon, lambda: daemon.cancel("serve-drain"))
    assert res["state"] == CANCELLED
    assert len(res["rounds"]) == 1
    assert daemon.store.state("serve-drain") == CANCELLED
    assert any(j.num_slices for j in server.jobs.values())


def test_drain_is_lost_to_a_thief_of_the_port_daemon(server, daemon,
                                                     tmp_path):
    """Another pod of the port's runtime takes the drain's lease mid-round;
    the drain meets the port's ``StaleLease`` at the next boundary and
    stops as the daemon's ``LOST``."""
    from repro_torch.core.jobstore import RUNNING
    from repro_torch.runtime.daemon import LOST, ServingDaemon
    thief = ServingDaemon(str(tmp_path / "serve.sqlite"), pod_id="thief")

    def steal():
        assert thief.store.requeue_expired(now=time.time() + 1e6)
        assert thief.store.acquire_lease("serve-drain", "thief", 30.0) == 2

    try:
        res = _drain(server, daemon, steal)
        assert res["state"] == LOST == "lost"
        assert len(res["rounds"]) == 1
        assert daemon.store.state("serve-drain") == RUNNING
        assert daemon.store.lease_of("serve-drain")[:2] == ("thief", 2)
        assert thief.serve_once() is None       # external: never claimed
    finally:
        thief.close()
