"""The port's H100 hardware model (``core/profiles.py``, ``core/costs.py``)
against the reference's TPU one, and the scheduler and engine planning on
it with cost-derived serving profiles. Every test that plans on ``H100``
points the port's stores at its own tmp dir, so nothing lands in
``artifacts/``."""
import dataclasses
import math

import pytest

from repro.core import profiles as JP
from repro_torch.core import costs as TC
from repro_torch.core import profiles as TP
from repro_torch.core.engine import LaneSpec, WorkloadEngine
from repro_torch.core.simulator import IPCTable
from repro_torch.launch.serve import Job, job_profile

# (flops, HBM bytes, blocks): compute-bound, memory-bound, balanced at v5e
COSTS = [(3.1e15, 2.2e11, 528), (4.4e12, 9.0e11, 1056), (197e12, 819e9, 4)]

# chip_smoke.py phase 3's tenants, and the reference demo's rwkv6 prefill
JOBS = [Job("a-phi3-prefill", "phi3-mini-3.8b", "prefill", 4, 1, 2048),
        Job("b-phi3-decode", "phi3-mini-3.8b", "decode", 8, 8, 4096),
        Job("c-rwkv-prefill", "rwkv6-1.6b", "prefill", 4, 4, 2048)]


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("flops,nbytes,blocks", COSTS)
def test_h100_profile_at_v5e_peaks_is_the_tpu_profile(flops, nbytes, blocks):
    """Called with the v5e peaks, ``h100_profile_from_costs`` gives the
    port's and the reference's ``tpu_profile_from_costs`` bit for bit."""
    got = TP.h100_profile_from_costs("k", flops, nbytes, blocks,
                                     peak_flops=TC.PEAK_FLOPS,
                                     hbm_bw=TC.HBM_BW)
    assert got == TP.tpu_profile_from_costs("k", flops, nbytes, blocks)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JP.tpu_profile_from_costs("k", flops, nbytes, blocks))


@pytest.mark.parametrize("flops,nbytes,blocks", COSTS)
def test_h100_profile_defaults_to_the_data_sheet_peaks(flops, nbytes, blocks):
    """989 TFLOP/s dense bf16 and 3.35 TB/s, the H100 SXM at 700 W; the
    ridge moves from 240 to 295 FLOP a byte, so a step's PUR/MUR moves
    toward memory."""
    assert (TC.H100_PEAK_FLOPS, TC.H100_HBM_BW) == (989e12, 3.35e12)
    got = TP.h100_profile_from_costs("k", flops, nbytes, blocks)
    assert got == TP.tpu_profile_from_costs(
        "k", flops, nbytes, blocks, peak_flops=989e12, hbm_bw=3.35e12)
    v5e = TP.tpu_profile_from_costs("k", flops, nbytes, blocks)
    assert got.rm >= v5e.rm and got.mur >= v5e.mur


def test_h100_spec_and_its_virtual_sm():
    """132 SMs of 4 schedulers and 32 resident blocks, peak IPC 4 at
    1980 MHz; bw_per_sm from HBM bytes/s over (SMs x clock) in 128-byte
    requests, the rule that puts C2050 at 0.0701 beside its 0.0699."""
    h = TP.H100
    assert (h.n_sm, h.units_per_sm, h.n_schedulers, h.peak_ipc,
            h.freq_mhz) == (132, 32, 4, 4.0, 1980.0)
    assert h.bw_per_sm == 3.35e12 / (132 * 1980e6) / 128
    assert abs(h.bw_per_sm - 0.1001) < 1e-4
    assert abs(144e9 / (14 * 1147e6) / 128 - TP.C2050.bw_per_sm) < 2e-4
    v = h.virtual()
    assert (v.name, v.n_sm, v.n_schedulers, v.units_per_sm) == \
        ("H100-virtual", 132, 1, 8)
    assert v.bw_per_sm == h.bw_per_sm / 4 and v.peak_ipc == 1.0
    assert TP.GPUS["H100"] is h
    assert TP.content_digest(h) == TP.content_digest(dataclasses.replace(h))


def _profiles(spec, fn):
    return {job.name: job_profile(job, spec, fn) for job in JOBS}


def test_serving_profiles_count_n_sm_blocks_a_slice():
    """A slice is one step over every SM: ``num_slices x n_sm`` blocks on
    either spec (on the v5e, n_sm = 1: one block a slice, as in the
    reference)."""
    for spec, fn in ((TP.H100, TP.h100_profile_from_costs),
                     (TP.TPU_V5E, TP.tpu_profile_from_costs)):
        for job in JOBS:
            prof = job_profile(job, spec, fn)
            assert prof.num_blocks == job.num_slices * spec.n_sm
            assert prof.insns_per_block == 1000.0


def test_find_coschedule_on_h100_pairs_prefill_with_decode(store):
    """The scheduler on ``H100``: the compute-bound prefills pair with the
    memory-bound decode, at slice sizes that are whole multiples of the
    132 SMs and fill the units they claim."""
    engine = WorkloadEngine()
    profs = _profiles(TP.H100, TP.h100_profile_from_costs)
    sched = engine.scheduler_for(TP.H100, profs, alpha_p=0.2, alpha_m=0.2,
                                 cp_margin=0.0)
    cs = sched.find_coschedule(list(profs))
    assert cs.k2 is not None and cs.cp > 0
    assert "b-phi3-decode" in (cs.k1, cs.k2)
    assert cs.s1 % 132 == 0 and cs.s2 % 132 == 0
    assert cs.s1 >= cs.w1 * 132 and cs.s2 >= cs.w2 * 132
    assert 1 <= cs.w1 and 1 <= cs.w2 and cs.w1 + cs.w2 <= 8


def test_engine_lane_on_h100_runs_every_job(store):
    """An engine replay lane on ``H100`` with cost-derived profiles:
    co-schedules at least once, runs every job in some phase, and predicts
    a finite makespan, the end of its last phase."""
    profs = _profiles(TP.H100, TP.h100_profile_from_costs)
    order = [job.name for job in JOBS]
    truth = IPCTable(TP.H100.virtual(), rounds=1500, persist=False)
    lane = LaneSpec("KERNELET", profs, order, TP.H100, truth, alpha_p=0.2,
                    alpha_m=0.2, cp_margin=0.0)
    res = WorkloadEngine().run([lane])[0]
    assert res.n_coschedules >= 1
    labels = " ".join(label for _, label in res.time_line)
    assert all(name in labels for name in order), labels
    assert 0 < res.total_cycles < math.inf
    assert res.total_cycles == res.time_line[-1][0]
