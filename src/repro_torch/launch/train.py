"""End-to-end training driver (``src/repro/launch/train.py`` on PyTorch).

Wires every substrate together on one device: the futurized data
pipeline (prefetch overlap, paper Fig. 4), the microbatched train step
under the cell's plan (remat, microbatches, bf16 compute), async
checkpointing (paper Fig. 5), the step monitor (straggler detection) and
fail-stop resume.  The step updates the params and the optimizer state in
place (the reference's ``donate_argnums=(0, 1)``).  It runs on the card
unless the caller asks for another device.

With ``--workers N`` (N > 1) or ``--elastic``, the driver routes through
``repro_torch.training.elastic.ElasticTrainer`` instead: the batch is
sharded across local workers, each shard's forward and backward replayed
as one captured graph, the gradients combined on the driver's device, and
a worker death mid-run reshards over the survivors (DESIGN.md §16).
``--chaos SEED`` arms the fault injector with a deterministic mid-run
worker kill drawn from SEED — the recovery drill.  ``train(port=...)``
trains over a parcel port's localities instead (``ParcelWorker``s: each
shard one ``invoke`` parcel to a worker process).

``train(mesh=...)`` trains over a ``DeviceMesh`` (``launch.mesh``) under
the plan's logical-axis rules (or ``rules``): the params and AdamW
moments are ``DTensor``s placed by ``tree_sharding`` of the family's
``param_specs`` (each rank holds its shards), the batch is placed by
``batch_logical_specs`` through the pipeline, and the step runs on the
``DTensor``s; the kernels run on local shards
(``kernels._autograd.kernel_with_plain_grad``).  The losses are
replicated scalars.  The elastic route shards the batch over workers, not
over a mesh, and refuses one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 10 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 6 --batch 4 --seq 2048 --workers 4 --chaos 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
        --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import replace

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, smoke as smoke_cfg
from repro_torch.data.pipeline import Pipeline, SyntheticTokens
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import axis_rules, sharding_for, tree_sharding
from repro_torch.fault.monitor import StepMonitor
from repro_torch.models import batch_logical_specs, get_model
from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import make_init, make_train_step

__all__ = ["main", "train"]


def train(
    arch: str = "olmo-1b",
    *,
    use_smoke: bool = True,
    steps: int = 20,
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-4,
    ckpt_dir: "str | None" = None,
    ckpt_every: int = 10,
    resume: bool = False,
    mesh=None,
    rules: "dict | None" = None,
    log_every: int = 1,
    seed: int = 0,
    schedule_total: "int | None" = None,
    workers: int = 1,
    elastic: bool = False,
    port=None,
    chaos: "int | None" = None,
    grad_compression: bool = False,
    device="cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint with
    ``resume``) on ``device``.  Returns {"losses", "final_loss",
    "stragglers", "step_seconds", "params", "opt_state"}: the reference's
    keys plus each step's wall seconds; the elastic route adds "events"
    and "recoveries".  With ``mesh`` the step runs on ``DTensor``s over it
    (``device`` is then the mesh's device on this rank) and "params" and
    "opt_state" are ``DTensor``s."""
    if elastic or workers > 1 or port is not None:
        if mesh is not None:
            raise ValueError("train: the elastic route shards the batch over workers, not over "
                             "a device mesh (the reference's elastic route ignores mesh=); pass "
                             "one or the other")
        return _train_elastic(
            arch,
            use_smoke=use_smoke,
            steps=steps,
            batch=batch,
            seq=seq,
            lr=lr,
            ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every,
            resume=resume,
            log_every=log_every,
            seed=seed,
            schedule_total=schedule_total,
            workers=workers,
            port=port,
            chaos=chaos,
            grad_compression=grad_compression,
            device=device,
        )
    cfg = smoke_cfg(get_config(arch)) if use_smoke else get_config(arch)
    shape = ShapeConfig("custom", seq_len=seq, global_batch=batch, kind="train")
    plan = plan_for(cfg, shape)
    if batch < 2 * plan.num_microbatches:
        plan = replace(plan, num_microbatches=1)
    horizon = schedule_total or steps  # LR schedule horizon survives restarts
    opt_cfg = OptConfig(lr=lr, warmup_steps=min(100, horizon // 10 + 1), total_steps=horizon)

    if mesh is not None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        rules = rules or plan.rules
        ctx = axis_rules(rules, mesh)
    else:
        device = torch.device(device)
        ctx = contextlib.nullcontext()
    with ctx:
        return _train_loop(cfg, shape, opt_cfg, plan, mesh, rules, device, steps=steps,
                           ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
                           log_every=log_every, seed=seed)


def _place(mesh, cfg, shape, rules, params, opt_state):
    """Params and moments as ``DTensor``s on ``mesh`` by the family's
    ``param_specs``; the step counter replicated; and the batch keys'
    shardings by ``batch_logical_specs``."""
    psh = tree_flatten(tree_sharding(mesh, get_model(cfg).param_specs(cfg), rules, params))[0]

    def put(tree):
        flat, tdef = tree_flatten(tree)
        return tree_unflatten(tdef, [s.distribute(x) for x, s in zip(flat, psh)])

    params = put(params)
    opt_state = {"m": put(opt_state["m"]), "v": put(opt_state["v"]),
                 "step": sharding_for(mesh, (), rules).distribute(opt_state["step"])}
    dims = {"tokens": (shape.global_batch, shape.seq_len),
            "labels": (shape.global_batch, shape.seq_len)}
    bsh = {k: sharding_for(mesh, names, rules, shape=dims[k])
           for k, names in batch_logical_specs(cfg, shape).items() if k in dims}
    return params, opt_state, bsh


def _scalar(x) -> float:
    """A metric as a float (a ``DTensor`` metric gathered whole first)."""
    from torch.distributed.tensor import DTensor

    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _train_loop(cfg, shape, opt_cfg, plan, mesh, rules, device, *, steps, ckpt_dir, ckpt_every,
                resume, log_every, seed) -> dict:
    seq, batch = shape.seq_len, shape.global_batch
    step_fn = make_train_step(cfg, shape, opt_cfg, plan, donate=True)
    params, opt_state = make_init(cfg, opt_cfg, device=device)(seed)
    bsh = None
    if mesh is not None:
        params, opt_state, bsh = _place(mesh, cfg, shape, rules, params, opt_state)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr and mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore((params, opt_state))
        start_step = extra.get("step", mgr.latest_step())
        cursor = extra.get("cursor", start_step)
    else:
        cursor = 0

    source = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)
    pipe = Pipeline(source, start=cursor, depth=2, device=device, shardings=bsh)
    monitor = StepMonitor()

    losses, step_seconds = [], []
    ckpt_futs = []
    try:
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            idx, dev_batch = pipe.get()  # overlapped host->device feed
            params, opt_state, metrics = step_fn(params, opt_state, dev_batch)
            loss = _scalar(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            losses.append(loss)
            step_seconds.append(dt)
            if log_every and step % log_every == 0:
                print(
                    f"step {step:5d} loss {loss:8.4f} gnorm {_scalar(metrics['gnorm']):7.3f} "
                    f"lr {_scalar(metrics['lr']):.2e} {dt * 1000:7.1f} ms",
                    flush=True,
                )
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                # async save (Fig. 5 pattern): training continues while the
                # writer thread serializes
                ckpt_futs.append(
                    mgr.save_async(
                        step + 1,
                        (params, opt_state),
                        extra={"step": step + 1, "cursor": pipe.state()["cursor"]},
                    )
                )
    finally:
        # Crash safety: a mid-loop failure must not abandon the writer
        # thread mid-serialization or leave prefetch batches in flight —
        # settle both before the exception propagates.
        pipe.close()
        for f in ckpt_futs:
            try:
                f.wait()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        if mgr:
            mgr.wait()
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "stragglers": len(monitor.events),
        "step_seconds": step_seconds,
        "params": params,
        "opt_state": opt_state,
    }


def _train_elastic(
    arch: str,
    *,
    use_smoke: bool,
    steps: int,
    batch: int,
    seq: int,
    lr: float,
    ckpt_dir: "str | None",
    ckpt_every: int,
    resume: bool,
    log_every: int,
    seed: int,
    schedule_total: "int | None",
    workers: int,
    port,
    chaos: "int | None",
    grad_compression: bool,
    device,
) -> dict:
    """Elastic data-parallel route (DESIGN.md §16).  ``chaos`` arms a
    deterministic mid-run worker kill: the run must complete anyway, with
    the post-kill loss curve bit-identical to a clean survivor-count run
    from the same state (the property the tests drill)."""
    from repro_torch.fault.inject import FaultInjector
    from repro_torch.training.elastic import ElasticTrainer

    trainer = ElasticTrainer(
        arch,
        use_smoke=use_smoke,
        batch=batch,
        seq=seq,
        lr=lr,
        seed=seed,
        workers=workers,
        port=port,
        grad_compression=grad_compression,
        total_steps=schedule_total or steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        resume=resume,
        device=device,
    )
    try:
        if chaos is not None:
            inj = FaultInjector(seed=int(chaos))
            kill_after, victim = inj.plan_kill(steps - trainer.cursor, trainer.workers)
            inj.kill_at_step(victim, trainer.cursor + kill_after)
        out = trainer.run(max(0, steps - trainer.cursor), log_every=log_every)
    finally:
        trainer.close()
    out["recoveries"] = [e for e in trainer.events if e[0] == "death"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1, help="data-parallel workers (>1 = elastic)")
    ap.add_argument("--elastic", action="store_true", help="elastic route even with 1 worker")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm the fault injector: kill a seeded-random worker mid-run")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 stochastic-rounding gradient parcels")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args()

    out = train(
        args.arch,
        use_smoke=args.smoke,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        seed=args.seed,
        workers=args.workers,
        elastic=args.elastic,
        chaos=args.chaos,
        grad_compression=args.grad_compression,
        device=args.device,
    )
    print(f"final loss: {out['final_loss']:.4f}  stragglers: {out['stragglers']}")
    for ev in out.get("recoveries", []):
        print(f"recovered: worker {ev[2]} died at step {ev[1]}, resharded over survivors")


if __name__ == "__main__":
    main()
