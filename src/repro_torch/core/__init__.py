"""Core futurized accelerator runtime on PyTorch and CUDA (the paper's
contribution), mirroring ``repro.core``'s public names.

    from repro_torch.core import get_all_devices, Dim3, wait_all

    dev = get_all_devices(1, 0).get()[0]                 # Listing 1 (CUDA devices)
    buf = dev.create_buffer(1000, np.float32).get()
    futs = [buf.enqueue_write(0, host_data)]
    prog = dev.create_program_with_file(".../stencil/ops.py").get()
    futs.append(prog.build("stencil"))                   # nvcc on the compile queue
    wait_all(futs)                                       # Listing 2, line 38
    prog.run([buf], "stencil", grid=Dim3(4096), block=Dim3(256), out=[buf]).get()
    result = buf.enqueue_read_sync()

Streams map onto ``torch.cuda.Stream``s and events onto
``torch.cuda.Event``s:

    s1, s2 = dev.create_stream(), dev.create_stream()
    s1.enqueue_write(a, 0, host_a); prog.launch([a], "k", out=[ra], stream=s1)
    s2.enqueue_write(b, 0, host_b); prog.launch([b], "k", out=[rb], stream=s2)
    s2.wait_event(s1.record())

Any kernel on any device, placed by a scheduler (``REPRO_LOGICAL_DEVICES=4``
splits a card into 4 logical devices):

    sched = Scheduler(get_all_devices().get(), policy="least_loaded")
    prog.run_on_any([buf], "partition_map", out=[res], scheduler=sched).get()

A captured graph is a ``torch.cuda.CUDAGraph`` a segment (one for a plan on
one device's chain; one a segment, each on its chain's lane, for a plan over
several chains or devices):

    with dev.capture("step") as g:
        w = buf.enqueue_write(0, host_data)
        prog.run([buf], "stencil", out=[out])
        r = out.enqueue_read()
    exe = g.instantiate()
    result = exe.replay(feeds={w: new_data}).get()[r]
"""
from repro_torch.core.agas import GID, HOST_KEY, Placement, Registry, locality_of, registry, set_locality_id
from repro_torch.core.buffer import Buffer
from repro_torch.core.device import Device, Locality, get_all_devices, get_all_localities
from repro_torch.core.executor import (
    Lane,
    LaneDispatcher,
    QueueLoad,
    Runtime,
    WorkQueue,
    coalesce,
    flush_coalesced,
    get_runtime,
    reset_runtime,
)
from repro_torch.core.futures import (
    Future,
    FutureState,
    Promise,
    async_,
    dataflow,
    make_exceptional_future,
    make_ready_future,
    wait_all,
    when_all,
    when_any,
)
from repro_torch.core.graph import GraphExec, GraphResult, TaskGraph, capture, current_graph
from repro_torch.core.program import Dim3, Program
from repro_torch.core.scheduler import (
    POLICIES,
    AffinityPolicy,
    LeastLoadedPolicy,
    PercolationPolicy,
    PlacementPolicy,
    RoundRobinPolicy,
    Scheduler,
    StaticPolicy,
    get_scheduler,
    locality_of_key,
    make_policy,
    set_scheduler,
)
from repro_torch.core.stream import Event, Stream

__all__ = [
    "GID",
    "HOST_KEY",
    "Placement",
    "Registry",
    "registry",
    "locality_of",
    "set_locality_id",
    "Buffer",
    "Device",
    "Locality",
    "get_all_devices",
    "get_all_localities",
    "Runtime",
    "WorkQueue",
    "Lane",
    "LaneDispatcher",
    "QueueLoad",
    "get_runtime",
    "reset_runtime",
    "coalesce",
    "flush_coalesced",
    "Stream",
    "Event",
    "Future",
    "FutureState",
    "Promise",
    "async_",
    "dataflow",
    "make_exceptional_future",
    "make_ready_future",
    "wait_all",
    "when_all",
    "when_any",
    "Dim3",
    "Program",
    "Scheduler",
    "PlacementPolicy",
    "StaticPolicy",
    "RoundRobinPolicy",
    "LeastLoadedPolicy",
    "AffinityPolicy",
    "PercolationPolicy",
    "POLICIES",
    "get_scheduler",
    "set_scheduler",
    "make_policy",
    "locality_of_key",
    "TaskGraph",
    "GraphExec",
    "GraphResult",
    "capture",
    "current_graph",
]
