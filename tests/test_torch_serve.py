"""The port's SharedPodServer against the reference server: the same drain
decisions, the same step outputs on the same weights, the scheduler's
balanced ratio driving the port's coschedule, and no silent CPU run."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import ref as jax_ref
from repro.launch import serve as JS
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.core import jobstore as TJS
from repro_torch.core.engine import WorkloadEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as TS

# tests/test_integration.py:139-140
JOBS = [("a-prefill", "phi3-mini-3.8b", "prefill", 6, 1, 32),
        ("b-decode", "starcoder2-15b", "decode", 6, 1, 32)]


def _jax_weights(arch):
    """The reference server's weights: init_params of the reduced config
    from PRNGKey(seed=0), as numpy, in the port's layout."""
    jp = JT.init_params(reduced(get_config(arch)), jax.random.PRNGKey(0))
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers over the same jobs. Each package keeps its decision,
    Markov and calibration stores in a fresh directory of its own, so each
    side makes every decision itself and neither replays the other's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_IPC_CACHE", str(tmp_path_factory.mktemp("ref")))
        mp.setenv("REPRO_TORCH_IPC_CACHE",
                  str(tmp_path_factory.mktemp("port")))
        ref_srv = JS.SharedPodServer()
        port = TS.SharedPodServer(device="cpu")
        for job in JOBS:
            ref_srv.submit(JS.Job(*job))
            port.submit(TS.Job(*job), params=_jax_weights(job[1]))
        yield ref_srv, port


def _reset(*srvs):
    for srv in srvs:
        for name, *_, n, _b, _s in JOBS:
            srv.jobs[name].num_slices = n


def test_rounds_equal_reference(servers):
    ref_srv, port = servers
    _reset(ref_srv, port)
    want, got = ref_srv.drain(), port.drain()
    assert got["rounds"] == want["rounds"]
    assert all(j.num_slices == 0 for j in port.jobs.values())
    assert got["predicted_gain"] > 0.05          # complementary pair found
    assert got["predicted_gain"] == want["predicted_gain"]
    assert got["plan"]["predicted_makespan_cycles"] == \
        want["plan"]["predicted_makespan_cycles"]
    assert [ev[1:] for ev in port.log] == [ev[1:] for ev in ref_srv.log]


def test_arrival_and_fleet_plans_equal_reference(servers):
    ref_srv, port = servers
    _reset(ref_srv, port)
    from repro.core.engine import WorkloadEngine as JaxEngine
    want = ref_srv.plan_arrivals(JaxEngine(), 1e-4, slo_deadline=5e4)
    got = port.plan_arrivals(WorkloadEngine(), 1e-4, slo_deadline=5e4)
    assert got["predicted_makespan_cycles"] == \
        want["predicted_makespan_cycles"]
    assert got["latency"] == want["latency"]
    want = ref_srv.plan_fleet(2, 1e-4)
    got = port.plan_fleet(2, 1e-4)
    assert (got["per_pod"], got["deal"]) == (want["per_pod"], want["deal"])


def test_step_outputs_match_reference(servers):
    """Each tenant's step (prefill forward, decode step) on the reference's
    bf16 weights. Tolerance: XLA and PyTorch round bf16 intermediates at
    different places, one or two bf16 ulps (2^-6 at |logit| < 4) apart."""
    ref_srv, port = servers
    for name, *_ in JOBS:
        want = np.asarray(ref_srv._exec[name](), np.float32)
        got = port._exec[name]()
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2,
                                   rtol=2e-2)


def test_prefill_steps_go_through_flash_attention(servers, monkeypatch):
    """Every layer of a prefill step calls ops.flash_attention once; a
    decode step calls it never."""
    _, port = servers
    calls = []
    real = ops.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    port._exec["a-prefill"]()
    cfg = reduced(get_config("phi3-mini-3.8b"))
    assert calls == [(1, cfg.num_heads, 32, cfg.head_dim)] * cfg.num_layers
    port._exec["b-decode"]()
    assert len(calls) == cfg.num_layers


# the four recurrent tenants of chip_smoke.py's phase 3b, at reduced size
REC_JOBS = [("c-rwkv6-prefill", "rwkv6-1.6b", "prefill", 4, 1, 32),
            ("d-rwkv6-decode", "rwkv6-1.6b", "decode", 8, 2, 32),
            ("e-rgemma-prefill", "recurrentgemma-9b", "prefill", 4, 1, 32),
            ("f-rgemma-decode", "recurrentgemma-9b", "decode", 8, 2, 32)]


@pytest.fixture(scope="module")
def recurrent_servers(tmp_path_factory):
    """Both servers over the recurrent jobs, each package with a fresh store
    of its own; the port's tenants of one arch share one set of weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_IPC_CACHE", str(tmp_path_factory.mktemp("ref")))
        mp.setenv("REPRO_TORCH_IPC_CACHE",
                  str(tmp_path_factory.mktemp("port")))
        ref_srv = JS.SharedPodServer()
        port = TS.SharedPodServer(device="cpu")
        weights = {arch: _jax_weights(arch) for arch in
                   {job[1] for job in REC_JOBS}}
        for job in REC_JOBS:
            ref_srv.submit(JS.Job(*job))
            port.submit(TS.Job(*job), params=weights[job[1]])
        yield ref_srv, port


def test_recurrent_rounds_equal_reference(recurrent_servers):
    ref_srv, port = recurrent_servers
    want, got = ref_srv.drain(), port.drain()
    assert got["rounds"] == want["rounds"]
    assert any(k2 is not None for _, k2, *_ in got["rounds"])
    assert all(j.num_slices == 0 for j in port.jobs.values())
    assert got["predicted_gain"] == want["predicted_gain"]
    assert got["plan"]["predicted_makespan_cycles"] == \
        want["plan"]["predicted_makespan_cycles"]
    assert [ev[1:] for ev in port.log] == [ev[1:] for ev in ref_srv.log]


def test_recurrent_prefill_outputs_match_reference(recurrent_servers):
    """Each prefill tenant's step on the reference's bf16 weights.
    Tolerance: the error's norm within 3e-2 of the reference's logits'
    norm. XLA and PyTorch round bf16 intermediates at different places, and
    RWKV6's chains of bf16 token-shift mixes compound it through the layers
    (1.8e-2 for rwkv6, 1.3e-2 for recurrentgemma, 5.4e-3 for the phi3
    tenant on this seed); the f32 tests in tests/test_torch_recurrent.py
    hold the same models at 2e-4. (A decode slice of the port advances its
    tenant's recurrent state in place, where the reference's recomputes
    from its initial caches; decode numerics are held there too.)"""
    ref_srv, port = recurrent_servers
    for name, _, phase, *_ in REC_JOBS:
        if phase != "prefill":
            continue
        want = np.asarray(ref_srv._exec[name](), np.float32)
        got = port._exec[name]()
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        err = np.linalg.norm(got.float().numpy() - want)
        assert err < 3e-2 * np.linalg.norm(want), (name, err)


def test_recurrent_prefill_steps_go_through_k4_and_k5(recurrent_servers,
                                                       monkeypatch):
    """A prefill step calls ops.rwkv6_scan once per rwkv6 layer and
    ops.rg_lru once per rglru layer; a decode step calls neither."""
    _, port = recurrent_servers
    calls = []
    for name in ("rwkv6_scan", "rg_lru"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    for job, arch, phase, *_ in REC_JOBS:
        calls.clear()
        port._exec[job]()
        kinds = reduced(get_config(arch)).layer_kinds()
        want = [{"rwkv6": "rwkv6_scan", "rglru": "rg_lru"}[k] for k in kinds
                if k != "local"] if phase == "prefill" else []
        assert calls == want, (job, calls)


H100_JOBS = [("a-phi3-prefill", "phi3-mini-3.8b", "prefill", 4, 1, 32),
             ("b-phi3-decode", "phi3-mini-3.8b", "decode", 8, 2, 32)]


def test_h100_drain_issues_each_jobs_slices(tmp_path, monkeypatch):
    """The server on the H100 model (a slice is 132 blocks, one a SM):
    the phi3 prefill x decode pair is co-scheduled at least once, every
    job runs exactly its ``num_slices`` steps, and the engine plan's
    co-scheduled phases pair the same jobs as the executed rounds."""
    from repro_torch.core.profiles import H100, h100_profile_from_costs
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path))
    srv = TS.SharedPodServer(gpu_spec=H100,
                             profile_fn=h100_profile_from_costs,
                             device="cpu")
    for job in H100_JOBS:
        srv.submit(TS.Job(*job))
    ran = dict.fromkeys(srv.jobs, 0)
    for name, step in list(srv._exec.items()):
        srv._exec[name] = lambda _n=name, _s=step: ran.__setitem__(
            _n, ran[_n] + 1) or _s()
    assert all(p.num_blocks == j[3] * 132 for j, p in
               zip(H100_JOBS, srv.profiles.values()))
    res = srv.drain()
    assert ran == {name: n for name, _, _, n, _, _ in H100_JOBS}
    assert all(j.num_slices == 0 for j in srv.jobs.values())
    pairs = {(k1, k2) for k1, k2, *_ in res["rounds"] if k2 is not None}
    assert pairs == {("a-phi3-prefill", "b-phi3-decode")}
    planned = {tuple(label[3:].split("@")[0].split("+"))
               for _, label in res["plan"]["time_line"]
               if label.startswith("co:")}
    assert planned == pairs and res["plan"]["n_coschedules"] >= 1


def test_demo_plans_on_the_h100_model(tmp_path, monkeypatch, capsys):
    """``demo()`` on the CPU: the reference's tenants but the one that
    waits for MoE and MLA, planned and printed as H100-model decisions."""
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path))
    TS.demo("cpu")
    out = capsys.readouterr().out
    for name in ("tenantA-phi3-prefill", "tenantC-rwkv-prefill",
                 "tenantD-sc2-decode"):
        assert f"submitted {name}" in out
    assert "engine plan (H100 model)" in out and "v5e" not in out
    assert "H100-model predicted CP" in out


def test_scheduler_feeds_fused_kernel():
    """Port of tests/test_integration.py:88-108: Kernelet's balanced slice
    ratio drives the port's coschedule."""
    from repro_torch.core.calibrate import calibrated_benchmarks
    from repro_torch.core.markov import MarkovModel, balanced_slice_sizes
    from repro_torch.core.profiles import C2050

    profs = calibrated_benchmarks(C2050)
    model = MarkovModel(C2050.virtual())
    pc, tea = profs["PC"], profs["TEA"]
    c1, c2 = model.pair_ipc(pc, 2, tea, 2)
    s1, s2 = balanced_slice_sizes(pc, c1, tea, c2, 14, 14, 14)
    run_a = max(1, round(s1 / 14))
    run_b = max(1, round(s2 / 14))
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    mm, st = ops.coschedule(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(x), run_a=min(run_a, 8),
                            run_b=min(run_b, 8))
    mref, sref = jax_ref.coschedule(a, b, x, 2.0)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mref), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sref), atol=1e-6)


def test_server_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SharedPodServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SharedPodServer(device="cuda")
    assert TS.SharedPodServer(device="cpu").device.type == "cpu"


class _Daemon:
    """What ``drain(daemon=)`` uses of a serving daemon, on the port's own
    JobStore, so the store raises the port's ``StaleLease`` and
    ``JobStoreError``."""
    lease_ttl = 30.0

    def __init__(self, path):
        self.store = TJS.JobStore(path)
        self.pod_id = "pod-under-test"
        self._control = {}

    def submit(self, job_id, spec):
        self.store.create_job(job_id, spec)

    def pause(self, job_id):
        if self.store.state(job_id) == TJS.RUNNING:
            self._control[job_id] = "pause"

    def poll_control(self, job_id):
        return self._control.pop(job_id, None)


def _drain_with_hook(port, dmn, hook):
    """Drain with ``hook`` run before the first prefill slice."""
    orig = port._exec["a-prefill"]
    calls = []

    def hooked():
        calls.append(1)
        if len(calls) == 1:
            hook()
        return orig()

    port._exec["a-prefill"] = hooked
    try:
        return port.drain(daemon=dmn, plan_first=False)
    finally:
        port._exec["a-prefill"] = orig


def test_drain_through_daemon(servers, tmp_path):
    """The daemon hooks carried over unchanged: pause at a round boundary
    with slices preserved, resume under a fresh epoch, finish."""
    _, port = servers
    _reset(port)
    dmn = _Daemon(str(tmp_path / "serve.sqlite"))
    try:
        res = _drain_with_hook(port, dmn, lambda: dmn.pause("serve-drain"))
        assert res["state"] == TJS.PAUSED
        remaining = {n: j.num_slices for n, j in port.jobs.items()}
        assert any(remaining.values())
        _, ck = dmn.store.load_checkpoint("serve-drain")
        assert ck["pending"] == {n: v for n, v in remaining.items() if v}
        res2 = port.drain(daemon=dmn, plan_first=False)
        assert res2["state"] == TJS.FINISHED
        assert all(j.num_slices == 0 for j in port.jobs.values())
        assert dmn.store.lease_of("serve-drain")[:2] == ("", 2)
    finally:
        dmn.store.close()


def test_drain_stops_when_its_lease_is_stolen(servers, tmp_path):
    """Another pod takes the drain's lease mid-round: the next round
    boundary's heartbeat meets the port's StaleLease and the drain stops
    as ``lost``, leaving the thief's lease and the rest of the slices."""
    _, port = servers
    _reset(port)
    dmn = _Daemon(str(tmp_path / "serve.sqlite"))

    def steal():
        assert dmn.store.requeue_expired(now=time.time() + 1e6)
        assert dmn.store.acquire_lease("serve-drain", "pod-thief", 30.0) == 2

    try:
        res = _drain_with_hook(port, dmn, steal)
        assert res["state"] == "lost"
        assert len(res["rounds"]) == 1
        assert any(j.num_slices for j in port.jobs.values())
        assert dmn.store.state("serve-drain") == TJS.RUNNING
        assert dmn.store.lease_of("serve-drain")[:2] == ("pod-thief", 2)
    finally:
        dmn.store.close()


def test_drain_rides_out_a_store_error(servers, tmp_path, monkeypatch):
    """A transient store failure at one round boundary never stops the
    drain: the port's JobStoreError is swallowed there and it finishes."""
    _, port = servers
    _reset(port)
    dmn = _Daemon(str(tmp_path / "serve.sqlite"))
    real, failed = dmn.store.renew_lease, []

    def flaky(*args, **kw):
        if not failed:
            failed.append(1)
            raise TJS.JobStoreError("database is busy")
        return real(*args, **kw)

    monkeypatch.setattr(dmn.store, "renew_lease", flaky)
    try:
        res = port.drain(daemon=dmn, plan_first=False)
        assert failed and res["state"] == TJS.FINISHED
        assert all(j.num_slices == 0 for j in port.jobs.values())
    finally:
        dmn.store.close()
