"""Fault-tolerant elastic data-parallel training over local workers
(``src/repro/training/elastic.py`` on PyTorch; DESIGN.md §16).

The cluster story, closed end-to-end: the same runtime that serves also
trains.  An ``ElasticTrainer`` holds the master params + optimizer state
on the driver's device (registered in AGAS, so the state is a resolvable
cluster object, not a Python local), shards each global batch across a
fleet of workers, and all-reduces the returned gradients before one AdamW
update:

* **Local workers** run their shard on this process's devices.  The shard
  step is captured once per (family, device, rows) as a ``TaskGraph`` —
  params/tokens/labels as write-fed buffers, one launch returning
  ``(*grad_leaves, loss)``, the whole forward and backward — and every
  later step replays it: on a card, one CUDA graph a shard (the kernels of
  the forward and of the remat recompute inside it), fed the driver's
  device tensors by a copy on the card.  Captures take turns (one at a
  time in the process); replays of different graphs run concurrently.
* **Parcel workers** ship the shard as ONE ``invoke`` parcel to a remote
  locality, which resolves ``repro_torch.training.elastic:shard_action``
  by name — source never crosses the wire — and replays the same captured
  shard graph there, on its own device.  On this route the params cross
  as host arrays, one D2H a step on the driver (as the reference's numpy
  does; large arrays take the shared-memory lane), and the gradients come
  back the same way.  ``kill()`` SIGKILLs the worker's process on a
  cluster port and flips the port's fail-fast gate on a loopback one.

Gradients may come back int8-compressed (``grad_compression``): stochastic
rounding from a ``torch.Generator`` seeded from the task's ``ckey``, one
derived seed a leaf in leaf order, so a replayed step re-rounds bit for
bit (the reference draws ``jax.random`` bits: the port's bits differ).

**Determinism contract** (what the chaos tests pin down): shard splits
are a pure function of (batch, active-worker count); gradients are
combined on the driver in float32, in shard order, weighted by shard rows,
each product and each sum rounded on its own (bit-equal to the reference's
numpy combine); the update is one AdamW.  A step is therefore a pure
function of (params, opt_state, cursor, active count) — re-executing it
after a failure, with any workers on the same devices, from the same
state gives bit-identical results.

**Elasticity, both directions** (fail-stop model, DESIGN.md §6):

* *Down*: a worker death mid-step (Heartbeat miss or the fault injector)
  discards that step's partial results and re-executes the WHOLE step
  resharded over the survivors — recomputation from the AGAS-resident
  driver state, no checkpoint restore.  The loss curve from the reshard
  point is bit-identical to a clean N-1-worker run from the same state.
  Checkpoint restore remains the last resort for driver loss, via
  ``resume=True``.
* *Up*: a recovered (``revive()``) or newly added (``add_worker()``)
  worker is picked up at the next step boundary — the active set is
  re-read every step, exactly like the scheduler re-reads liveness.

Transient faults are not deaths: a dropped gradient parcel
(``ParcelDropped``) is re-sent to the same worker up to
``REPRO_ELASTIC_RETRIES`` times before the link is declared dead.

Where the port differs from the reference: the driver's params and moments
stay device tensors on ``device`` (the reference turns the params, and each
shard's gradients, into numpy every step), and the driver's device is an
argument (``device="cuda"``: the card unless the caller asks for another).
The shard graph is instantiated with ``donate=True``: the port copies each
write's payload into the graph's static input, so donation lets go of the
graph's own buffers and never touches the driver's tensors (with
``donate=False`` every replay would copy the params back into them).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import nullcontext
from typing import Any, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, smoke as smoke_cfg
from repro_torch.core import agas
from repro_torch.core.executor import get_runtime, on_runtime_reset
from repro_torch.core.parcel import host_value
from repro_torch.core.graph import TaskGraph
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distribution.recipes import plan_for
from repro_torch.fault.inject import ParcelDropped
from repro_torch.fault.monitor import Heartbeat, StepMonitor
from repro_torch.models import get_model
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.training.grad_compression import compress
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import make_init

__all__ = ["ElasticTrainer", "LocalWorker", "ParcelWorker", "WorkerDied", "graph_stats",
           "shard_action"]

F32 = torch.float32
# profiler ranges of an elastic step's parts, read by tools/profile_torch_train.py
ELASTIC_SPANS = ("elastic.shards", "elastic.combine", "elastic.update")


class WorkerDied(RuntimeError):
    """A worker was lost mid-step; the trainer reshards over survivors."""


# ---------------------------------------------------------------------------
# the shard step, shared by every route
# ---------------------------------------------------------------------------

# (arch, smoke, seq, global_batch) -> family dict.  Module-level so every
# worker/trainer in the process shares one family, one treedef, one
# captured-graph cache — repeated trainers (property tests, benchmark
# sweeps) pay a capture once per shard shape, not once per trainer.
_FAMILIES: "dict[tuple, dict]" = {}
_GEXECS: "dict[tuple, tuple]" = {}  # (famkey, device.key, rows) -> capture entry
_PROGRAMS: "dict[tuple, Any]" = {}  # (famkey, device.key) -> Program
_CACHE_LOCK = threading.Lock()
# One capture at a time: a capture's warm-up and graph take memory that a
# second capture beside it would compete for, and the cached blocks freed
# before it are only free while no other capture holds a private pool.
_CAPTURE_LOCK = threading.Lock()


@on_runtime_reset
def _on_runtime_reset() -> None:
    """Drop the captured-graph and program caches when the runtime is
    torn down (``executor.reset_runtime``): their buffers hold queues
    owned by the dying runtime, and their AGAS records must be retired
    with them — a later memory-pressure spill must never try to evict a
    stale buffer onto a shut-down lane.  Dropping the graphs releases
    their CUDA graph memory pools.  ``_FAMILIES`` stays: plain functions,
    no runtime objects."""
    with _CACHE_LOCK:
        entries = list(_GEXECS.values())
        _GEXECS.clear()
        _PROGRAMS.clear()
    for _gexec, param_nodes, tok_node, lab_node, _launch in entries:
        for node in (*param_nodes, tok_node, lab_node):
            gid = getattr(node.buf, "gid", None)
            if gid is not None:
                agas.registry.unregister(gid)


def _shape_tree(node):
    """``param_shapes``' tree with every shape a leaf (a ``torch.Size``:
    the pytree walks plain tuples)."""
    if isinstance(node, dict):
        return {k: _shape_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_shape_tree(v) for v in node]
    return torch.Size(node)


def _get_family(arch: str, use_smoke: bool, seq: int, global_batch: int) -> dict:
    key = (str(arch), bool(use_smoke), int(seq), int(global_batch))
    with _CACHE_LOCK:
        fam = _FAMILIES.get(key)
    if fam is not None:
        return fam
    cfg = smoke_cfg(get_config(arch)) if use_smoke else get_config(arch)
    shape = ShapeConfig("custom", seq_len=seq, global_batch=global_batch, kind="train")
    plan = plan_for(cfg, shape)
    m = get_model(cfg)
    compute_dtype = torch.bfloat16 if plan.compute_dtype == "bfloat16" else F32
    shapes, treedef = tree_flatten(_shape_tree(m.param_shapes(cfg)))

    def cast(p):
        """Mixed precision (``train_step.py``'s rule): leaves of ndim >= 2
        compute in bf16, norms and biases stay f32."""
        if compute_dtype == F32:
            return p
        return tree_map(lambda x: x.to(compute_dtype) if (x.dtype == F32 and x.ndim >= 2)
                        else x, p)

    def grad_step(params, batch):
        """One shard's contribution: (mean loss over shard rows, f32 grads)
        with respect to the f32 masters.  No microbatching — a shard is
        already a batch fraction."""
        masters = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
        loss = m.loss_fn(cfg, cast(tree_unflatten(treedef, masters)), batch,
                         remat=plan.remat, q_block=plan.q_block)
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.to(F32)
                 for p, g in zip(masters, grads)]
        return loss.detach().to(F32), tree_unflatten(treedef, grads)

    def init(seed: int, device):
        """``make_init``'s seeded params on ``device``: an elastic run and
        ``train()`` on the same seed start from the same params."""
        return make_init(cfg, OptConfig(), device=device)(seed)[0]

    fam = {
        "key": key,
        "cfg": cfg,
        "plan": plan,
        "treedef": treedef,
        "n_leaves": len(shapes),
        "grad_step": grad_step,
        "init": init,
    }
    with _CACHE_LOCK:
        return _FAMILIES.setdefault(key, fam)


def _leaf_seed(base: int, i: int) -> int:
    """The rounding seed of leaf ``i`` under the task's base seed."""
    return base * (1 << 20) + i


def _pack_grads(flat: "list[torch.Tensor]", loss, task: dict) -> dict:
    """Reply of one shard; int8 stochastic rounding when the task asks for
    compression.  The rounding seed is derived from the task's ``ckey`` (a
    pure function of (seed, step, shard)), one seed a leaf, so a
    re-executed step re-rounds bit-identically."""
    out: dict = {"loss": loss}
    if task.get("compress"):
        base = int(task["ckey"]) % (2**31 - 1)
        qs, scales = [], []
        for i, g in enumerate(flat):
            gen = torch.Generator(device=g.device).manual_seed(_leaf_seed(base, i))
            q, s = compress(g, gen)
            qs.append(q)
            scales.append(s)
        out["q"] = qs
        out["scales"] = scales
    else:
        out["grads"] = flat
    return out


def _as_tensor(a, device) -> "torch.Tensor":
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:  # a wire or JAX array: torch wants its own
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def shard_action(payload: dict) -> dict:
    """The remote half of one data-parallel shard step.

    Resolved BY NAME (``repro_torch.training.elastic:shard_action``)
    through the parcel ``invoke`` action — source never crosses the wire.
    The payload carries flat param leaves + the shard's tokens/labels +
    config knobs, and may name the ``device`` platform to compute on
    (default: the card).  The shard runs on that platform's first device
    of this process by the route of ``REPRO_ELASTIC_ROUTE`` (default
    ``graph``: the captured shard graph, replayed, as a ``LocalWorker``
    runs it); the reply carries ``{loss, grads | (q, scales)}`` as tensors
    on that device (the parcel codec brings them to the host)."""
    from repro_torch.core.device import get_all_devices

    platform = torch.device(payload.get("device", "cuda")).type
    devs = get_all_devices(platform=platform).get()
    if not devs:
        raise RuntimeError(f"shard_action: this process has no {platform} device")
    return _run_shard_local(payload, devs[0], os.environ.get("REPRO_ELASTIC_ROUTE", "graph"))


def graph_stats(_payload=None) -> dict:
    """This process's captured shard graphs: for each ``"<device key>
    r<rows>"``, the kernels a replay runs (by package), its replays and its
    CUDA graphs.  (The ignored argument lets a parcel ``invoke`` read a
    worker's by name, ``repro_torch.training.elastic:graph_stats``.)"""
    with _CACHE_LOCK:
        entries = list(_GEXECS.items())
    return {f"{k[1]} r{k[2]}": {"arch": k[0][0], "recorded": e[0].recorded_launches,
                               "replays": e[0].graph_replays, "cuda_graphs": e[0].cuda_graphs}
            for k, e in entries}


def _fed_buffer(dev, shape, dtype):
    """A buffer that a graph write fills: its storage is released at once
    (the write gives it storage again)."""
    buf = dev.create_buffer(tuple(shape), dtype).get()
    buf._invalidate()
    return buf


def _gexec_for(fam: dict, dev, task: dict):
    """Captured shard graph for (family, device, rows): params + tokens +
    labels as write-fed buffers, one launch.  Cached so every later step
    replays it (on a card, one CUDA graph)."""
    rows = int(task["tokens"].shape[0])
    key = (fam["key"], dev.key, rows)
    with _CACHE_LOCK:
        entry = _GEXECS.get(key)
    if entry is not None:
        return entry
    with _CAPTURE_LOCK:
        with _CACHE_LOCK:
            entry = _GEXECS.get(key)
        if entry is not None:  # another worker captured it meanwhile
            return entry
        n = fam["n_leaves"]
        treedef = fam["treedef"]
        grad_step = fam["grad_step"]

        def shard_grad(*args):
            params = tree_unflatten(treedef, list(args[:n]))
            batch = {"tokens": args[n], "labels": args[n + 1]}
            loss, grads = grad_step(params, batch)
            return tuple(tree_flatten(grads)[0]) + (loss,)

        pkey = (fam["key"], dev.key)
        with _CACHE_LOCK:
            prog = _PROGRAMS.get(pkey)
        if prog is None:
            prog = dev.create_program({"shard_grad": shard_grad}, f"elastic:{dev.key}").get()
            with _CACHE_LOCK:
                prog = _PROGRAMS.setdefault(pkey, prog)

        g = TaskGraph(f"elastic:{dev.key}:r{rows}")
        param_nodes = [g.write(_fed_buffer(dev, leaf.shape, leaf.dtype))
                       for leaf in task["params"]]
        toks, labs = np.asarray(task["tokens"]), np.asarray(task["labels"])
        tok_node = g.write(_fed_buffer(dev, toks.shape, toks.dtype))
        lab_node = g.write(_fed_buffer(dev, labs.shape, labs.dtype))
        launch = g.run(prog, [w.buf for w in param_nodes] + [tok_node.buf, lab_node.buf],
                       "shard_grad")
        if dev.is_cuda:
            # Blocks cached by other streams cannot serve the capture's
            # private pool: hand them back first.
            torch.cuda.empty_cache()
        gexec = g.instantiate(donate=True)
        entry = (gexec, param_nodes, tok_node, lab_node, launch)
        with _CACHE_LOCK:
            _GEXECS[key] = entry
        return entry


def _run_shard_local(task: dict, dev, route: str) -> dict:
    fam = _get_family(task["arch"], task["smoke"], int(task["seq"]), int(task["global_batch"]))
    if route == "graph":
        gexec, param_nodes, tok_node, lab_node, launch = _gexec_for(fam, dev, task)
        feeds = {node: leaf for node, leaf in zip(param_nodes, task["params"])}
        feeds[tok_node] = np.ascontiguousarray(task["tokens"])
        feeds[lab_node] = np.ascontiguousarray(task["labels"])
        outs = list(gexec.replay(feeds=feeds).get()[launch])
        return _pack_grads(outs[:-1], outs[-1], task)
    # direct route (REPRO_ELASTIC_ROUTE=jit): the family's step called
    # eagerly on the worker's device, on that device's stream
    td = dev.torch_device
    stream = dev.default_stream.cuda_stream
    with torch.cuda.stream(stream) if stream is not None else nullcontext():
        params = tree_unflatten(fam["treedef"], [_as_tensor(a, td) for a in task["params"]])
        batch = {"tokens": _as_tensor(task["tokens"], td),
                 "labels": _as_tensor(task["labels"], td)}
        loss, grads = fam["grad_step"](params, batch)
        out = _pack_grads(tree_flatten(grads)[0], loss, task)
        if stream is not None:
            stream.synchronize()  # resolved at completion, as a replay is
    return out


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


class LocalWorker:
    """One data-parallel worker on this process: its own serial work queue
    (shards overlap across workers), its own ``Heartbeat``, optionally
    pinned to one device (else the first device of ``platform``, which the
    trainer sets to its driver's platform).  ``occupancy_tokens_per_s``
    models device busy time with a GIL-releasing sleep (benchmark use)."""

    kind = "local"

    def __init__(
        self,
        wid: int,
        device=None,
        *,
        route: "str | None" = None,
        occupancy_tokens_per_s: "float | None" = None,
        heartbeat_timeout: float = 600.0,
        on_dead=None,
        platform: "str | None" = None,
    ):
        self.wid = int(wid)
        self.device = device
        self.platform = platform
        self.route = route or os.environ.get("REPRO_ELASTIC_ROUTE", "graph")
        self.occupancy = occupancy_tokens_per_s
        self.queue = get_runtime().queue(f"elastic-w{self.wid}")
        self.heartbeat = Heartbeat(timeout_s=heartbeat_timeout, on_dead=on_dead)
        self._dead = False
        self._kill_at: "Optional[int]" = None

    def _device(self):
        if self.device is None:
            from repro_torch.core.device import get_all_devices

            self.device = get_all_devices(platform=self.platform or "cuda").get()[0]
        return self.device

    def alive(self) -> bool:
        return not self._dead

    def mark_dead(self) -> None:
        self._dead = True

    def kill(self) -> None:
        """Immediate death: heartbeat expires and ``on_dead`` edge-fires."""
        self._dead = True
        self.heartbeat.force_expire()
        self.heartbeat.check()

    def revive(self) -> None:
        """Re-admit: picked up by the trainer at the next step boundary."""
        self._dead = False
        self.heartbeat.tick()

    def kill_at_step(self, step: int) -> None:
        """Arm a mid-step death (fault injection): the worker dies inside
        its own shard execution at training step ``step``."""
        self._kill_at = int(step)

    def run_shard(self, task: dict):
        def _run():
            if self._kill_at is not None and task["step"] >= self._kill_at:
                self._kill_at = None
                self.kill()
                raise WorkerDied(
                    f"worker {self.wid} killed by fault injection at step {task['step']}"
                )
            if self.occupancy:
                time.sleep(np.asarray(task["tokens"]).size / float(self.occupancy))
            out = _run_shard_local(task, self._device(), self.route)
            self.heartbeat.tick()
            return out

        return self.queue.submit(_run)


def _tensors(reply: dict) -> dict:
    """A shard's reply off the wire (numpy leaves) as tensors."""
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)) if not isinstance(a, torch.Tensor)
                    else a, reply)


class ParcelWorker:
    """One data-parallel worker behind a parcel port locality.  The shard
    ships as ONE ``invoke`` parcel (arrays take the shm lane when large);
    liveness is the port's (heartbeat monitor / fail-fast gate)."""

    kind = "parcel"

    def __init__(self, wid: int, port, locality_id: int):
        self.wid = int(wid)
        self.port = port
        self.lid = int(locality_id)
        self._dead = False
        self._kill_at: "Optional[int]" = None

    def alive(self) -> bool:
        return not self._dead and self.port.alive(self.lid)

    def mark_dead(self) -> None:
        self._dead = True

    def kill(self) -> None:
        self._dead = True
        if hasattr(self.port, "kill"):  # loopback: flip the fail-fast gate
            self.port.kill(self.lid)
        else:  # cluster: SIGKILL the worker process
            w = self.port._workers.get(self.lid)
            if w is not None and w.proc.is_alive():
                w.proc.kill()

    def revive(self) -> None:
        self._dead = False
        if hasattr(self.port, "revive"):
            self.port.revive(self.lid)

    def kill_at_step(self, step: int) -> None:
        self._kill_at = int(step)

    def run_shard(self, task: dict):
        if self._kill_at is not None and task["step"] >= self._kill_at:
            self._kill_at = None
            self.kill()  # the call below fails fast: a mid-step death
        payload = dict(task, device=getattr(self.port, "platform", "cuda"))
        return self.port.call(
            self.lid, "invoke", {"fn": "repro_torch.training.elastic:shard_action",
                                 "payload": payload}
        ).then(_tensors, executor="inline")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _owned(a, device) -> "torch.Tensor":
    """A copy of ``a`` (numpy or tensor) on ``device``: the trainer updates
    its state in place and must never write into a caller's arrays."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    return torch.as_tensor(np.array(a)).to(device)


class ElasticTrainer:
    """Elastic data-parallel trainer over local workers.

    ``state=(params, opt_state), start_step=k`` seeds the trainer from a
    snapshot (numpy or tensors; the chaos tests' reference runs);
    ``total_steps`` pins the LR-schedule horizon so split runs match a
    single run bit-for-bit.  ``device`` is the driver's: its params, AdamW
    moments, gradient combine and update live there.
    """

    def __init__(
        self,
        arch: str = "olmo-1b",
        *,
        use_smoke: bool = True,
        batch: int = 8,
        seq: int = 64,
        lr: float = 3e-4,
        seed: int = 0,
        workers: int = 2,
        port=None,
        devices: "list | None" = None,
        grad_compression: bool = False,
        occupancy_tokens_per_s: "float | None" = None,
        total_steps: "int | None" = None,
        state: "tuple | None" = None,
        start_step: int = 0,
        ckpt_dir: "str | None" = None,
        ckpt_every: int = 0,
        resume: bool = False,
        max_retries: "int | None" = None,
        heartbeat_timeout: float = 600.0,
        device="cuda",
    ):
        from repro_torch.checkpoint.checkpoint import CheckpointManager

        self.arch = arch
        self.use_smoke = bool(use_smoke)
        self.batch = int(batch)
        self.seq = int(seq)
        self.lr = float(lr)
        self.seed = int(seed)
        self.grad_compression = bool(grad_compression)
        self.total_steps = total_steps
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if max_retries is None:
            max_retries = int(os.environ.get("REPRO_ELASTIC_RETRIES", "2"))
        self.max_retries = int(max_retries)

        self._fam = _get_family(arch, use_smoke, seq, batch)
        self.source = SyntheticTokens(self._fam["cfg"].vocab_size, seq, batch, seed=seed)
        self.monitor = StepMonitor()
        self.events: "list[tuple]" = []  # ("death"|"retry"|"join", step, wid, ...)
        self.history: "list[float]" = []
        self.step_seconds: "list[float]" = []  # each step's wall seconds
        self._opt_cfg: "Optional[OptConfig]" = None
        self._ckpt_every = int(ckpt_every)
        self._mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self._ckpt_futs: list = []

        # -- state: snapshot > checkpoint > fresh init ----------------------
        self.cursor = int(start_step)
        if state is not None:
            params, opt_state = state
            params = tree_map(lambda a: _owned(a, self.device), params)
            opt_state = tree_map(lambda a: _owned(a, self.device), opt_state)
        else:
            params = self._fam["init"](seed, self.device)
            opt_state = init_opt_state(params)
            if resume and self._mgr and self._mgr.latest_step() is not None:
                (params, opt_state), extra = self._mgr.restore((params, opt_state))
                self.cursor = int(extra.get("step", self._mgr.latest_step()))
        self.params, self.opt_state = params, opt_state

        # -- fleet -----------------------------------------------------------
        self.workers: list = []
        if port is not None:
            for i, loc in enumerate(port.localities()):
                self.workers.append(ParcelWorker(i, port, loc.process_index))
        else:
            for i in range(int(workers)):
                dev = devices[i % len(devices)] if devices else None
                self.workers.append(
                    LocalWorker(
                        i,
                        device=dev,
                        occupancy_tokens_per_s=occupancy_tokens_per_s,
                        heartbeat_timeout=heartbeat_timeout,
                        platform=self.device.type,
                    )
                )

        # The master state is an AGAS-resident cluster object: any locality
        # (or a post-mortem driver) can resolve it by GID — recovery reads
        # live state, not a stale checkpoint.
        self._agas_gid = agas.registry.register(
            self,
            agas.Placement(device_key=agas.HOST_KEY),
            kind="elastic-state",
            arch=str(arch),
            batch=self.batch,
            seq=self.seq,
        )

    # -- fleet management ----------------------------------------------------

    @property
    def agas_gid(self) -> int:
        return self._agas_gid

    def active_workers(self) -> list:
        return [w for w in self.workers if w.alive()]

    def add_worker(self, worker=None):
        """Scale up: admit ``worker`` (or spawn a fresh ``LocalWorker``)
        from the next step boundary on."""
        if worker is None:
            wid = max((w.wid for w in self.workers), default=-1) + 1
            worker = LocalWorker(wid)
        if getattr(worker, "platform", "") is None:
            worker.platform = self.device.type
        self.workers.append(worker)
        self.events.append(("join", self.cursor, worker.wid))
        return worker

    # -- one step -------------------------------------------------------------

    @staticmethod
    def _split(batch: dict, n: int) -> "list[dict]":
        toks = np.array_split(batch["tokens"], n)
        labs = np.array_split(batch["labels"], n)
        return [{"tokens": t, "labels": l} for t, l in zip(toks, labs)]

    def _task(self, shard: dict, shard_i: int, n_active: int, flat_params) -> dict:
        # ckey: pure function of (seed, step, shard, fleet size) — the
        # compression re-rounds identically when the step is re-executed.
        ckey = ((self.seed * 1_000_003 + self.cursor) * 131 + shard_i) * 31 + n_active
        return {
            "arch": self.arch,
            "smoke": self.use_smoke,
            "seq": self.seq,
            "global_batch": self.batch,
            "step": self.cursor,
            "params": flat_params,
            "tokens": shard["tokens"],
            "labels": shard["labels"],
            "compress": self.grad_compression,
            "ckey": ckey,
        }

    def _await_shard(self, w, fut, mk_task):
        """One shard's result, retrying dropped parcels on the same worker;
        everything else becomes a ``WorkerDied`` reshard."""
        attempts = 0
        while True:
            try:
                return fut.get()
            except ParcelDropped as e:
                attempts += 1
                if attempts > self.max_retries or not w.alive():
                    raise WorkerDied(
                        f"worker {w.wid}: {attempts} consecutive parcels dropped"
                    ) from e
                self.events.append(("retry", self.cursor, w.wid))
                fut = w.run_shard(mk_task())
            except WorkerDied:
                raise
            except Exception as e:  # noqa: BLE001 - transport/worker failure
                if w.alive():
                    raise  # a real error on a live worker is a bug, not a death
                raise WorkerDied(f"worker {w.wid} lost mid-step: {e}") from e

    def step(self) -> float:
        """One data-parallel step; survives any worker deaths inside it."""
        if self._opt_cfg is None:
            self._ensure_opt(1)
        t0 = time.perf_counter()
        batch = self.source.batch(self.cursor)
        B = int(batch["tokens"].shape[0])
        flat_params = tree_flatten(self.params)[0]
        if self.device.type == "cuda":
            # The last update has ended before a shard on another stream
            # copies the params (and before any shard stream reuses memory
            # that this stream still read).
            torch.cuda.current_stream(self.device).synchronize()
        if any(w.kind == "parcel" for w in self.workers):
            # Parcel workers get host arrays: one D2H a step, shared by
            # every parcel shard (and every retry) of the step.
            flat_params = [host_value(t) for t in flat_params]

        with record_function(ELASTIC_SPANS[0]):
            while True:
                active = self.active_workers()
                if not active:
                    raise RuntimeError(
                        "elastic trainer has no live workers: every worker died; "
                        "restart the driver with resume=True to recover from the "
                        "latest checkpoint"
                    )
                n = min(len(active), B)
                active = active[:n]
                shards = self._split(batch, n)
                futs = [
                    (w, i, w.run_shard(self._task(shards[i], i, n, flat_params)))
                    for i, w in enumerate(active)
                ]
                results: list = [None] * n
                death = None
                for w, i, fut in futs:
                    if death is not None:
                        try:  # settle the rest; their results are discarded
                            fut.exception()
                        except Exception:  # noqa: BLE001
                            pass
                        continue
                    try:
                        results[i] = self._await_shard(
                            w, fut, lambda i=i, n=n: self._task(shards[i], i, n, flat_params)
                        )
                    except WorkerDied as e:
                        w.mark_dead()
                        death = (w, e)
                if death is None:
                    break
                # Reshard and re-execute the WHOLE step from the driver's
                # AGAS-resident state (pure: params/opt_state untouched so
                # far); the partial results go first.
                del futs, results
                self.events.append(("death", self.cursor, death[0].wid, str(death[1])))

        rows = [int(s["tokens"].shape[0]) for s in shards]
        with record_function(ELASTIC_SPANS[1]):
            grads_flat, loss = self._combine(results, rows, B, device=self.device)
        del futs, results
        grads = tree_unflatten(self._fam["treedef"], grads_flat)
        with record_function(ELASTIC_SPANS[2]):
            self.params, self.opt_state, _metrics = adamw_update(
                self._opt_cfg, self.params, grads, self.opt_state, donate=True)
        del grads, grads_flat
        loss = float(loss)  # waits for the update, queued before it on this stream
        self.cursor += 1
        self.history.append(loss)
        dt = time.perf_counter() - t0
        self.step_seconds.append(dt)
        self.monitor.record(self.cursor, dt)
        if self._mgr and self._ckpt_every and self.cursor % self._ckpt_every == 0:
            self._ckpt_futs.append(
                self._mgr.save_async(
                    self.cursor, (self.params, self.opt_state), extra={"step": self.cursor}
                )
            )
        return loss

    @staticmethod
    def _combine(results: list, rows: "list[int]", B: int, *, device=None
                 ) -> "tuple[list, torch.Tensor]":
        """Driver-side all-reduce: rows-weighted sum in float32, in shard
        order — bit-deterministic for a given (results, rows), and
        bit-equal to the reference's numpy combine: the weight is
        ``float32(rows / B)``, and each product and each sum is its own
        operation, rounded on its own (nothing fuses them).  ``device``:
        where it runs (default: the first result's)."""
        if device is None:
            first = results[0]
            device = (first["q"] if "q" in first else first["grads"])[0].device
        total: "list[torch.Tensor] | None" = None
        loss = torch.zeros((), dtype=F32, device=device)
        for r, res in zip(rows, results):
            w = torch.full((), float(np.float32(r / B)), dtype=F32, device=device)
            if "q" in res:  # int8 lane: decompress on the driver
                flat = [q.to(device).to(F32) * s.to(device)
                        for q, s in zip(res["q"], res["scales"])]
            else:
                flat = [g.to(device, F32) for g in res["grads"]]
            if total is None:
                total = [w * g for g in flat]
            else:
                total = [a + w * g for a, g in zip(total, flat)]
            loss = loss + w * res["loss"].to(device, F32)
        assert total is not None
        return total, loss

    # -- driving --------------------------------------------------------------

    def _ensure_opt(self, steps: int) -> None:
        if self._opt_cfg is None:
            horizon = int(self.total_steps or (self.cursor + steps))
            self._opt_cfg = OptConfig(
                lr=self.lr, warmup_steps=min(100, horizon // 10 + 1), total_steps=horizon
            )

    def run(self, steps: int, *, log_every: int = 0) -> dict:
        self._ensure_opt(steps)
        losses = []
        first = len(self.step_seconds)
        for _ in range(int(steps)):
            loss = self.step()
            losses.append(loss)
            if log_every and (self.cursor - 1) % log_every == 0:
                print(f"step {self.cursor - 1:5d} loss {loss:8.4f}", flush=True)
        self.wait()
        return {
            "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "stragglers": len(self.monitor.events),
            "events": list(self.events),
            "step_seconds": self.step_seconds[first:],
            "params": self.params,
            "opt_state": self.opt_state,
        }

    def snapshot(self) -> dict:
        """Host copy of the full training state (reference-run seeding)."""
        return {
            "params": tree_map(lambda t: t.detach().cpu().numpy().copy(), self.params),
            "opt_state": tree_map(lambda t: t.detach().cpu().numpy().copy(), self.opt_state),
            "step": self.cursor,
        }

    def wait(self) -> None:
        """Drain in-flight checkpoint writes."""
        futs, self._ckpt_futs = self._ckpt_futs, []
        for f in futs:
            f.wait()
        if self._mgr:
            self._mgr.wait()

    def close(self) -> None:
        self.wait()
        agas.registry.unregister(self._agas_gid)
