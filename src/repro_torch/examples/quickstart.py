"""Quickstart: train a reduced model end to end, slice a matmul with index
rectification (K1), and predict a co-schedule with the Markov model.

PyTorch counterpart of ``examples/quickstart.py``, at its sizes and steps.
On the card the sliced matmul is K1's f32 kernel, two launches of two
128 x 128 tiles each; the co-scheduling profit is the C2050 Markov model's
prediction (pure numpy), the reference's number exactly.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device

CKPT_DIR = "artifacts/quickstart_ckpt_torch"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. train a small model for a few steps (checkpointed, resumable)
    from repro_torch.launch.train import train
    res = train("phi3-mini-3.8b", use_reduced=True, steps=10, batch=4,
                seq=64, ckpt_dir=CKPT_DIR, device=dev)
    print(f"[train] loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f} "
          f"in {res['steps']} steps")

    # 2. sliced kernel execution (the paper's Fig. 3)
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    a = torch.randn(256, 256, generator=gen.manual_seed(0), device=dev)
    b = torch.randn(256, 256, generator=gen.manual_seed(1), device=dev)
    out = ops.sliced_matmul(a, b, slice_size=2)
    err = float((out - ref.matmul(a, b)).abs().max())
    print(f"[slice] sliced matmul == unsliced (measured max err {err:.2e})")

    # 3. Kernelet decision: which two kernels should share the GPU?
    from repro_torch.core.calibrate import calibrated_benchmarks
    from repro_torch.core.markov import MarkovModel, co_scheduling_profit
    from repro_torch.core.profiles import C2050
    profs = calibrated_benchmarks(C2050)
    model = MarkovModel(C2050.virtual())
    pc, tea = profs["PC"], profs["TEA"]
    ipc_pc, ipc_tea = model.single_ipc(pc), model.single_ipc(tea)
    c1, c2 = model.pair_ipc(pc, 2, tea, 2)
    cp = co_scheduling_profit((ipc_pc, ipc_tea), (c1, c2))
    print(f"[sched] PC+TEA co-scheduled at 2:2 units -> C2050-model "
          f"predicted CP {cp:+.1%} (memory-bound + compute-bound are "
          f"complementary)")
    return {"losses": res["losses"], "steps": res["steps"], "err": err,
            "cp": cp}


if __name__ == "__main__":
    main()
