"""Fault-tolerant training: inject host failures mid-run; the resilient
loop restores from the latest checkpoint and finishes with the same result
as a failure-free run. Also demonstrates straggler-aware slice
rebalancing.

PyTorch counterpart of ``examples/fault_tolerant_training.py``, at its
sizes, steps and failures. The checkpoint directory is emptied first, so
a restart restores this run's checkpoints and no earlier run's.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training
  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training \\
      --device cpu
"""
from __future__ import annotations

import argparse
import shutil

import numpy as np

from repro_torch.device import resolve_device

CKPT_DIR = "artifacts/ft_ckpt_torch"
FAIL_AT = {7: 2, 13: 1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    from repro_torch.launch.train import train
    from repro_torch.runtime.fault_tolerance import StragglerBalancer

    # --- crash at steps 7 (twice) and 13; training still completes ---
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    res = train("stablelm-3b", use_reduced=True, steps=16, batch=4, seq=64,
                ckpt_dir=CKPT_DIR, fail_at=dict(FAIL_AT), device=dev)
    print(f"[ft] survived 3 injected host failures; completed "
          f"{res['steps']} steps, loss {res['losses'][0]:.3f} -> "
          f"{res['losses'][-1]:.3f}")

    # --- straggler mitigation: Kernelet's balanced slicing on device
    # speeds (host latencies drawn from a seed: a model, not a measurement)
    bal = StragglerBalancer(n_hosts=8, total_slices=256)
    rng = np.random.default_rng(0)
    lat = np.array([1.0] * 7 + [2.5])          # host 7 is 2.5x slower
    for _ in range(30):
        for h in range(8):
            bal.observe(h, lat[h] * rng.uniform(0.95, 1.05))
    before = 32 * 2.5                           # equal shares: slow host gates
    bal.rebalance()
    print(f"[straggler] step makespan {before:.1f} -> {bal.makespan():.1f} "
          f"slice-times after rebalancing (shares: {bal.shares.tolist()})")
    return {"res": res, "shares": bal.shares.tolist(),
            "makespan": bal.makespan(), "before": before}


if __name__ == "__main__":
    main()
