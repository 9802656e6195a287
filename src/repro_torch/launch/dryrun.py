"""Multi-pod dry run: every (arch x shape) step on meta tensors, on the
production meshes, with its per-device argument bytes and counted FLOPs.

PyTorch counterpart of ``repro/launch/dryrun.py``'s cell runner, with its
command line and its ``run_cell`` rules (overrides, nested ones such as
``moe.a2a_dtype`` included; the ``fsdp`` layout for small archs at
``train_4k``; resident weights for serving archs under 30 B;
``applicable_shapes``; one JSON record a cell, written when the cell fails
too). The reference lowers and compiles each step with XLA on 256 or 512
forced host devices; here the step runs once, eagerly, on meta tensors
(shapes and dtypes, no data) from ``specs.input_specs`` under
``use_mesh`` with the shape-only production mesh, so nothing is allocated
and no collective runs. A record holds:

- ``memory.argument_size_in_bytes``: each device's bytes of every argument
  under the port's shardings (``sharding.shard_bytes``);
- ``cost.flops``: the step's FLOPs as ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` counts them: every matmul-class op (mm, bmm, addmm,
  attention, convolution) of every layer, forward and backward, and no
  elementwise op, over the global batch (on a ``ShapeMesh`` the train
  step cuts no dp block: ``sharding.dp_block``). XLA's ``cost_analysis`` counts each ``lax.scan`` body once
  (``benchmarks/roofline.py``), so the two are not the same number;
- ``model_flops`` and ``flops`` from ``core/costs.cell_cost``, the analytic
  count, beside it;
- for a cell that takes the expert-parallel MoE, ``a2a``: each device's
  all-to-all bytes, counted from the send buffers' shapes
  (``moe.ep_send_bytes``), since none is sent;
- ``not_counted``: the reference's XLA-only fields, and why.

A decode cell's step writes its token at the last position of the cache
(``t = seq_len - 1``), so it attends over all of it. The XLA HLO parsers
(``collective_bytes``, ``collective_bytes_structural``, ``trip_counts``)
have no counterpart: the port has no HLO to parse.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.core.costs import cell_cost
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import moe as M
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

COUNTED_BY = ("FlopCounterMode over every layer of the global batch's step "
              "(one process runs every shard of the shape-only mesh, so no "
              "dp block is cut); on meta tensors WKV6 runs its chunks at "
              "once and the RG-LRU scan without its loop, the same matmuls "
              "(none in the RG-LRU)")
NOT_COUNTED = {
    "temp_size_in_bytes": "XLA's buffer assignment of the compiled step; "
                          "the port runs the step eagerly on meta tensors, "
                          "which allocate nothing",
    "output_size_in_bytes": "XLA's output buffers; the port's step updates "
                            "its arguments in place",
    "generated_code_size_in_bytes": "XLA's compiled code; nothing is "
                                    "compiled",
    "collectives": "parsed from the compiled HLO in the reference; the port "
                   "has no HLO, and on the shape-only mesh no collective "
                   "runs (the all-to-all of an EP cell is in 'a2a')",
}


def _apply_overrides(cfg, overrides):
    typed = {}
    for k, v in overrides.items():
        if "." in k:                           # nested, e.g. moe.a2a_dtype
            parent, field = k.split(".", 1)
            sub = getattr(cfg, parent)
            cur = getattr(sub, field)
            val = (v in ("1", "true", "True", True)) \
                if isinstance(cur, bool) else type(cur)(v)
            typed[parent] = dataclasses.replace(sub, **{field: val})
            continue
        cur = getattr(cfg, k)
        typed[k] = type(cur)(v) if cur is not None and \
            not isinstance(cur, bool) else (v in ("1", "true", "True", True))
    return dataclasses.replace(cfg, **typed)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def argument_bytes(args, shardings) -> int:
    """Each device's bytes of every argument under its sharding."""
    return sum(SH.shard_bytes(a, s)
               for a, s in zip(_leaves(args), _leaves(shardings)))


def uses_ep(cfg, shape, mesh) -> bool:
    """The MoE block's condition for the expert-parallel route."""
    n = SH.axis_size(mesh, "model")
    seq = 1 if shape.phase == "decode" else shape.seq_len
    return (cfg.moe is not None and cfg.moe_impl == "ep"
            and cfg.layout == "2d" and n > 1 and seq % n == 0)


def a2a_bytes(cfg, shape, mesh) -> dict:
    """Each device's all-to-all bytes in one step of an EP cell, from the
    send buffers' shapes: two exchanges a MoE layer forward, two more in
    the backward of a train step."""
    n_sh = SH.axis_size(mesh, "model")
    n_dp = SH.axis_size(mesh, SH.dp_axes(mesh, cfg.layout))
    tokens = shape.global_batch * shape.seq_len // (n_dp * n_sh)
    n_moe = sum(T._layer_sig(cfg, i)[1] for i in range(cfg.num_layers))
    per_layer = M.ep_send_bytes(cfg, tokens, n_sh, 2)
    passes = 2 if shape.phase == "train" else 1
    return {"bytes_per_layer": per_layer, "moe_layers": n_moe,
            "bytes": per_layer * n_moe * passes,
            "counted_from": "send-buffer shapes"}


def run_step(cfg, shape, mesh):
    """The cell's step on meta tensors: (argument bytes a device, counted
    FLOPs)."""
    args, shardings = SP.input_specs(cfg, shape, mesh)
    with SH.use_mesh(mesh, cfg.layout), FlopCounterMode(display=False) as fc:
        if shape.phase == "train":
            step = make_train_step(
                cfg, SP.default_opt_config(cfg),
                moe_group=SP.moe_group_size(cfg, shape, mesh))
            step(*args)
        elif shape.phase == "prefill":
            make_prefill_step(cfg)(*args)
        else:
            params, caches, token, _ = args
            make_serve_step(cfg)(params, caches, token, shape.seq_len - 1)
    return argument_bytes(args, shardings), fc.get_total_flops()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             skip_existing: bool = True, overrides: dict = None,
             variant: str = ""):
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if variant:
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip] {tag}")
        return True
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh.shape,
              "phase": shape.phase, "variant": variant,
              "overrides": overrides or {}}
    try:
        cfg = get_config(arch)
        if overrides:
            cfg = _apply_overrides(cfg, overrides)
        # small dense archs train communication-bound under TP=16 at this
        # batch geometry: pure-FSDP layout is the optimized default
        if shape_name == "train_4k" and cfg.layout == "2d" and \
                cfg.param_count() < 2e10 and "layout" not in (overrides or {}):
            cfg = dataclasses.replace(cfg, layout="fsdp")
        # serving: resident weights for archs that fit 16 GB/chip at TP=16
        if shape.phase != "train" and cfg.param_count() < 3e10 and \
                "param_fsdp" not in (overrides or {}):
            cfg = dataclasses.replace(cfg, param_fsdp=False)
        if shape.name not in {s.name for s in applicable_shapes(cfg)}:
            print(f"[n/a ] {tag} (shape inapplicable: "
                  f"{'full attention' if not cfg.sub_quadratic else '?'})")
            return True
        t0 = time.time()
        arg_bytes, flops = run_step(cfg, shape, mesh)
        record["trace_s"] = round(time.time() - t0, 1)
        record["memory"] = {"argument_size_in_bytes": int(arg_bytes)}
        record["cost"] = {"flops": float(flops),
                          "counted_by": COUNTED_BY}
        costs = cell_cost(cfg, shape)
        record["model_flops"] = costs["model_flops"]
        record["flops"] = costs["flops"]
        record["layout"] = cfg.layout
        if uses_ep(cfg, shape, mesh):
            record["a2a"] = a2a_bytes(cfg, shape, mesh)
        record["not_counted"] = NOT_COUNTED
        record["ok"] = True
        print(f"[ ok ] {tag}  trace={record['trace_s']:.0f}s "
              f"flops={flops:.3e} (cell_cost {costs['flops']:.3e}) "
              f"args/device={arg_bytes / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {tag}: {record['error'][:200]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record.get("ok", False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="",
                    help="tag appended to the artifact name")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    args = ap.parse_args()
    overrides = dict(kv.split("=", 1) for kv in args.set)
    ok = True
    if args.all:
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in applicable_shapes(cfg):
                for mp in ((False, True) if args.both_meshes
                           else (args.multi_pod,)):
                    ok &= run_cell(arch, shape.name, mp, args.out,
                                   skip_existing=not args.force,
                                   overrides=overrides, variant=args.variant)
    else:
        for mp in ((False, True) if args.both_meshes else (args.multi_pod,)):
            ok &= run_cell(args.arch, args.shape, mp, args.out,
                           skip_existing=not args.force,
                           overrides=overrides, variant=args.variant)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
