"""End-to-end training driver.

PyTorch counterpart of ``repro/launch/train.py``: builds the model for
``--arch`` (full or reduced config), makes the host mesh
(``make_host_mesh(model_parallel)``: ``model = min(model_parallel, ranks)``,
so one process gets a (1, 1) mesh) and runs the resilient training loop
under it (checkpoint every ``max(steps // 4, 5)`` steps, restart from the
latest checkpoint after a failure). It runs on the card unless
``--device`` names another; on a machine without one use ``--device cpu
--reduced``.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch phi3-mini-3.8b --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 3 --batch 1 --seq 4096
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ResilientLoop


def build(arch: str, use_reduced: bool, opt_cfg=None):
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    opt_cfg = opt_cfg or adamw.OptConfig()
    return cfg, opt_cfg


def train(arch: str = "phi3-mini-3.8b", *, use_reduced: bool = True,
          steps: int = 20, batch: int = 8, seq: int = 128,
          ckpt_dir: str = "artifacts/ckpt", model_parallel: int = 1,
          seed: int = 0, fail_at=None, log_every: int = 5,
          compress_grads: bool = False, device=None):
    """``log_every`` is kept from the reference's signature, which does not
    read it either. ``device`` None means ``cuda``."""
    dev = resolve_device(device)
    cfg, opt_cfg = build(arch, use_reduced,
                         adamw.OptConfig(warmup_steps=10, total_steps=steps,
                                         compress_grads=compress_grads))
    own_group = not dist.is_initialized()  # made here, so destroyed here
    mesh = make_host_mesh(model_parallel, device=dev)
    try:
        with SH.use_mesh(mesh):
            return _train(cfg, opt_cfg, dev, steps, batch, seq, ckpt_dir,
                          seed, fail_at)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(cfg, opt_cfg, dev, steps, batch, seq, ckpt_dir, seed, fail_at):
    """The loop under the mesh: init, step function, ``ResilientLoop``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, device=dev)
    opt_state = adamw.init(opt_cfg, params)
    step_fn_raw = make_train_step(cfg, opt_cfg)
    loader = SyntheticLoader(cfg, batch, seq, seed=seed)

    history = []

    def step_fn(state, np_batch):
        params, opt_state = state
        tbatch = {k: torch.as_tensor(v, device=dev)
                  for k, v in np_batch.items()}
        params, opt_state, metrics = step_fn_raw(params, opt_state, tbatch)
        history.append(float(metrics["loss"]))
        return (params, opt_state), metrics

    loop = ResilientLoop(step_fn, (params, opt_state), loader,
                         ckpt_dir, ckpt_every=max(steps // 4, 5))
    t0 = time.time()
    (params, opt_state), end_step = loop.run(steps, fail_at=fail_at)
    dt = time.time() - t0
    return {"cfg": cfg, "params": params, "losses": history,
            "steps": end_step, "seconds": dt}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    res = train(args.arch, use_reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq,
                model_parallel=args.model_parallel,
                ckpt_dir=args.ckpt_dir,
                compress_grads=args.compress_grads, device=args.device)
    losses = res["losses"]
    print(f"arch={args.arch} steps={res['steps']} "
          f"loss[0]={losses[0]:.3f} loss[-1]={losses[-1]:.3f} "
          f"({res['seconds']:.1f}s)")


if __name__ == "__main__":
    main()
