"""End-to-end training driver (EASEY RUN command `train ...`), port of
``repro/launch/train.py``.

Wires the substrates together: BuildService (the tuner's plan and the
train step) -> DataPipeline (deterministic, restart-safe) ->
Checkpointer (atomic, async) -> fault tolerance (failure injection,
restart policy, straggler monitor).  Weights are drawn from ``seed``
(``init_params``), the same ones on every restart.

It runs on the card unless ``--device cpu`` (``device="cpu"``) is asked
for, and raises where there is no card; the target defaults to the
device's own (``nvidia:h100``: the RMSNorm kernel on every norm, its
remat recompute's included; ``local:cpu``: the plain versions).  A
target of several chips (``local:cpu-mesh8``: 8 CPU ranks over gloo)
trains on its mesh: ``train_main`` runs in each rank's process, after
the caller initialized the process group, the state sharded by the
rules engine (``runtime.elastic.reshard_state``) and the losses global;
its checkpoints gather the state to one writer rank and restore each
rank's shard (``Checkpointer(mesh=)``), so ``fail_at`` restarts every
rank from the same step.

    python -m repro_torch.launch.train --device cpu \\
        --arch deepseek-7b-smoke --steps 20 --seq-len 64 --global-batch 4
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.appspec import AppSpec
from repro_torch.core.build import BuildService
from repro_torch.core.target import (default_target, device_for, get_target,
                                     resolve_device)
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_for
from repro_torch.optim import make_optimizer
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerMonitor,
                                                 run_with_restarts)
from repro_torch.training.steps import init_train_state


def _timed(fn, *args, device: torch.device):
    """(fn's result, host seconds it took), the device drained before and
    after (an advisory step time: the straggler monitor's and the log's)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def train_main(arch: str = "deepseek-7b-smoke", steps: int = 20,
               target: str | None = None, seq_len: int = 64,
               global_batch: int = 4, ckpt_dir: str | None = None,
               ckpt_every: int = 5, async_ckpt: bool = True,
               fail_at: tuple[int, ...] = (), resume: bool = True,
               log=print, seed: int = 0, device=None) -> dict:
    """Train ``arch`` for ``steps`` steps of ``global_batch`` x
    ``seq_len`` tokens under the tuner's plan for ``target``.  Returns
    the reference's keys plus the per-step ``losses``, ``grad_norms`` and
    ``step_s``, the ``device`` and the final ``state``."""
    dev = resolve_device(device)
    tgt = get_target(target or default_target(dev))
    if device_for(tgt) != dev:
        raise ValueError(f"target {tgt.name} runs on {device_for(tgt)}, "
                         f"not {dev}")
    app = AppSpec(arch=arch, shape="train_4k",
                  shape_overrides={"seq_len": seq_len,
                                   "global_batch": global_batch},
                  run=f"train --steps {steps}")
    result = BuildService().build(app, tgt, lower=False)
    mesh = result.mesh if tgt.num_chips > 1 else None
    if mesh is not None and not mesh.live:
        raise RuntimeError(f"target {tgt.name} trains on {tgt.num_chips} "
                           f"ranks: run train_main in each process of an "
                           f"initialized process group of that size")
    model = model_for(app.model_config, remat=result.plan.remat_policy)
    opt = make_optimizer(result.plan.optimizer)
    pipeline = DataPipeline(model, app.shape_config, seed=seed, device=dev,
                            mesh=mesh)
    ckpt = Checkpointer(ckpt_dir, keep=3, async_writes=async_ckpt,
                        mesh=mesh) if ckpt_dir else None
    injector = FailureInjector(fail_at_steps=tuple(fail_at))
    straggler = StragglerMonitor()
    losses, grad_norms, step_s = {}, {}, {}
    final = {}

    def loop(start_step: int) -> int:
        params = init_params(result.tables["params"],
                             torch.Generator(device=dev).manual_seed(seed),
                             dev)
        state = init_train_state(model, opt, params, result.plan)
        if mesh is not None:
            state = reshard_state(state, result.tables["state"], mesh)
        if ckpt and start_step > 0:
            state, at = ckpt.restore(state)
            log(f"[train] restored checkpoint step {at}")
        step = start_step
        while step < steps:
            injector.check(step)
            batch = pipeline.batch_at(step)
            (state, metrics), dt = _timed(result.step_fn, state, batch,
                                          device=dev)
            loss = float(metrics["loss"])
            if straggler.observe(step, dt):
                log(f"[train] step {step}: straggler ({dt:.3f}s)")
            losses[step], step_s[step] = loss, dt
            grad_norms[step] = float(metrics["grad_norm"])
            if step % max(steps // 10, 1) == 0:
                log(f"[train] step {step} loss={loss:.4f} "
                    f"({dt*1e3:.1f} ms)")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step, state)
            step += 1
        if ckpt:
            ckpt.save(steps - 1, state)
            ckpt.wait()
        final["state"] = state
        return step

    if resume and ckpt:
        stats = run_with_restarts(loop, checkpointer=ckpt, logger=log)
    else:
        stats = {"final_step": loop(0), "restarts": 0}

    curve = [losses[s] for s in sorted(losses)]
    return {
        "arch": arch, "steps": stats["final_step"],
        "restarts": stats["restarts"],
        "first_loss": curve[0] if curve else float("nan"),
        "final_loss": curve[-1] if curve else float("nan"),
        "stragglers": len(straggler.flagged),
        "plan": result.plan,
        "losses": curve,
        "grad_norms": [grad_norms[s] for s in sorted(grad_norms)],
        "step_s": [step_s[s] for s in sorted(step_s)],
        "device": str(dev), "state": final.get("state"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", default="deepseek-7b-smoke")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the card; "
                        "'cpu' runs the plain versions on the CPU)")
    p.add_argument("--target", default=None,
                   help="deployment target (default: the device's own, "
                        "nvidia:h100 or local:cpu)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--global-batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=5)
    p.add_argument("--fail-at", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    out = train_main(arch=a.arch, steps=a.steps, target=a.target,
                     seq_len=a.seq_len, global_batch=a.global_batch,
                     ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                     fail_at=tuple(a.fail_at), seed=a.seed, device=a.device)
    print(f"final: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"in {out['steps']} steps ({out['restarts']} restarts)")


if __name__ == "__main__":
    main()
