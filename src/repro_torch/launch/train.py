"""End-to-end training on one card.

The port of ``repro/launch/train.py``: config -> compiled train step
(with credit counter) -> multicast data pipeline -> AdamW -> checkpoint
manager -> fault-tolerant supervisor loop.  ``build`` compiles the step as
the reference's ``jax.jit`` does: a ``launch.compile.CompiledStep`` with the
parameters and optimizer state static, one CUDA graph per batch key on the
card (forward, backward, clipping, AdamW and the credit counter inside),
replayed at every step after the key's first; ``disable_compile()`` runs
the same path eagerly.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --reduced --device cpu --fused-adamw --steps 20 --batch 4 --seq 32

``--arch`` defaults to the reference CLI's ``mamba2-370m``; every
``ARCH_IDS`` entry trains.  ``--data-mesh``/``--model-mesh`` (the
reference's) train on a (data, model) ``DeviceMesh`` over the process
group the caller initialised (``torch.distributed``, one rank per device;
``torchrun`` sets one up): params, moments and batches are DTensors placed
by ``runtime.sharding``, and a step's credits count every device.
``--fused-adamw`` sends the optimizer update through the fused AdamW
kernel (CUDA on the card, its plain version on the CPU): the counterpart
of the reference optimizer's ``use_pallas=True``, which the reference CLI
has no switch for.  ``--device`` defaults to ``cuda`` and raises without a
card.  ``build`` and ``run`` take a ``ModelConfig``, so a caller can train a
config cut to any depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.sync import credit_threshold
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch.compile import CompiledStep
from repro_torch.launch.device import resolve_device
from repro_torch.launch.mesh import check_mesh_device, host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, scaled_down
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import StepSupervisor, SupervisorConfig


def _scalar(x) -> float:
    from torch.distributed.tensor import DTensor
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def build(arch: str | ModelConfig, *, reduced: bool,
          opt: AdamWConfig | None = None, vocab: int | None = None,
          fused_adamw: bool = False, device: str | torch.device = "cuda",
          mesh=None):
    """Config, device and compiled train step for ``arch``: (cfg, device,
    step).

    ``step(params, opt_state, batch)`` is a ``CompiledStep`` of
    ``make_train_step``'s function, the counterpart of the reference's
    ``jax.jit(bundle.fn, ..., donate_argnums=(0, 1))``: the params and the
    optimizer state are its static arguments (updated in place; every call
    must pass the same tensors), the batch is copied into a buffer kept per
    batch key (``{"tokens"}`` and ``{"embeds", "labels"}`` are two keys).
    On the card each key's first call runs eagerly and captures a CUDA
    graph in the step's own memory pool; every later call replays it.
    """
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if reduced:
        cfg = scaled_down(cfg)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab_size=vocab)
    if cfg.frontend == "vision_patches":
        # Stub frontend: embeddings are "precomputed patches" — for the
        # training run we train over token ids instead (text mode).
        cfg = dataclasses.replace(cfg, frontend="")
    dev = resolve_device(device)
    fn = make_train_step(cfg, opt_cfg=opt, remat=False,
                         fused_adamw=fused_adamw, mesh=mesh)
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    step = CompiledStep(fn, device=dev, static_argnums=(0, 1), pool=pool,
                        name="train_step")
    return cfg, dev, step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fused-adamw", action="store_true",
                    help="update through the fused AdamW kernel")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                      total_steps=args.steps)
    mesh = host_mesh((args.data_mesh, args.model_mesh), args.device)
    cfg, dev, step = build(args.arch, reduced=args.reduced, opt=opt,
                           fused_adamw=args.fused_adamw, device=args.device,
                           mesh=mesh)
    return run(cfg, step, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               log_every=args.log_every, resume=args.resume, device=dev,
               mesh=mesh)


def run(cfg: ModelConfig, train_step, *, steps: int, batch: int, seq: int,
        ckpt_dir: str | Path = "", ckpt_every: int = 50, log_every: int = 10,
        resume: bool = False, device: str | torch.device = "cuda",
        mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` supervised steps of ``train_step``.

    Parameters are drawn with seed 0 on ``device``; batches come from the
    data pipeline with seed 1.  With a ``mesh`` (the train step must be
    built over the same one), params and moments are placed by
    ``param_specs``/``opt_specs`` and batches over the data axes.  Returns
    the losses read at each logging point, the steps done, the
    supervisor's per-step seconds (host queueing + credit wait), faults
    and restarts, and the final ``params`` and ``opt_state``: the tensors
    drawn here, updated in place by every step and restored into by a
    resume or a rollback, so a compiled ``train_step`` holds them
    throughout.
    """
    dev = resolve_device(device)
    if mesh is not None:
        check_mesh_device(mesh, dev)
    params = init_params(cfg, seed=0, device=dev)
    shardings = None
    if mesh is not None:
        from repro_torch.runtime.sharding import (opt_specs, param_specs,
                                                  to_shardings)
        p_spec = param_specs(params, cfg, mesh)
        params = to_shardings(params, p_spec, mesh)
        shardings = (p_spec, opt_specs(p_spec))
    opt_state = init_opt_state(params)

    data = DataPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                   global_batch=batch, seed=1), dev, mesh=mesh)

    ckpt_dir = ckpt_dir or Path(tempfile.gettempdir()) / \
        f"repro_torch_ckpt_{cfg.name}"
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    start_step = 0
    if resume:
        try:
            (params, opt_state), start_step, _ = ckpt.restore_latest(
                (params, opt_state), shardings=shardings, mesh=mesh)
            print(f"resumed from step {start_step}")
        except FileNotFoundError:
            pass

    def step_fn(state, tokens):
        p, o = state
        p, o, metrics = train_step(p, o, {"tokens": tokens})
        return (p, o), metrics

    sup = StepSupervisor(step_fn, ckpt,
                         SupervisorConfig(ckpt_every=ckpt_every),
                         credit_threshold=credit_threshold(mesh))

    losses, step_seconds, faults, restarts = [], [], [], 0
    t0 = time.time()
    state = (params, opt_state)
    step = start_step
    try:
        while step < steps:
            state, rep = sup.run(state, data, min(step + log_every, steps),
                                 start_step=step, shardings=shardings,
                                 mesh=mesh)
            step += rep.steps_done
            step_seconds += rep.step_seconds
            faults += rep.faults
            restarts += rep.restarts
            loss = _scalar(rep.final_metrics.get("loss", float("nan")))
            losses.append(loss)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
            if rep.preempted:
                break
    finally:
        data.close()
    return {"losses": losses, "steps": step, "cfg": cfg.name,
            "step_seconds": step_seconds, "faults": faults,
            "restarts": restarts, "params": state[0],
            "opt_state": state[1]}


if __name__ == "__main__":
    out = main()
    print(f"final loss: {out['losses'][-1]:.4f}")
