"""Serving under a closed loop: ``clients`` callers, each sending its next
request when its last one resolves, through the port's
``PagedServeEngine.from_config`` (``submit`` and its futures).

Set-up: the weights from the seed (the reference module's layout, in the
configuration's serving dtype), the engine with a pool that holds every
client's longest request, one step graph captured at each row count of the
decode palette, one prompt at the longest and one at the shortest
length through ``submit``, and ``ramp_seconds`` of the traffic itself, so
that the window opens on an engine already under load.  In the window a
request counts when its future resolves.  Once it has
closed, the requests still in flight are waited for, the engine is closed,
and a sample of the finished requests (the longest among them) is held to
the plain reference (``correct``).

End-to-end: ``output_tokens_per_s``, the tokens of the requests that
completed in the window over its seconds, and ``request_latency_p95_s``,
submit to result, over every request completed in the window, both taken
by the client.  A traced run also keeps the engine's counters over the
window, each prefill batch and decode step the engine ran (host stamps
around its calls), and the device trace of ``trace_seconds`` in the middle
of the window (the profiler runs from before the engine starts until it is
closed), for the per-layer metrics.
"""
from __future__ import annotations

import gc
import queue
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchlib import port, traffic as traffic_mod
from benchlib.result import percentile
from benchlib.serve_check import check_served

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _warm_palette(eng, dev, palette, prompt_len, vocab):
    """One eager step and a capture at each row count of the palette, on
    stand-in sequences prefilled in one batch and freed after."""
    from repro_torch.core import Promise
    from repro_torch.serving.paged import _PagedRequest

    rows = max(palette)
    prompt = np.arange(prompt_len, dtype=np.int32) % vocab
    tokens = torch.from_numpy(np.tile(prompt, (rows, 1))).to(dev.torch_device)
    reqs = []
    with eng._on_stream():
        k, v, state, _ = eng.prefill_fn(tokens, None)
        for i in range(rows):
            r = _PagedRequest(prompt, 1 << 30, Promise(), time.monotonic(), rid=-1 - i)
            r.seq = eng.kv.new_seq(dev)
            eng.kv.append(r.seq, k[i], v[i])
            if state is not None:
                r.seq.set_state({n: t[i] for n, t in state.items()})
            r.out.append(0)
            reqs.append(r)
        del k, v, state
    lane = eng._lane_for(dev)
    for w in palette:
        lane._step(reqs[:w])  # eager, then captured
        lane._step(reqs[:w])  # replayed
    for r in reqs:
        eng.kv.free_seq(r.seq)
    return lane


class _Record:
    """What a traced run keeps of the engine's calls: prefill batches
    ``(start_ns, end_ns, rows, tokens)``, decode steps ``(ready_ns, rows,
    resident lengths)`` and host spans ``(label, start_ns, end_ns)``."""

    def __init__(self):
        self.prefills, self.steps, self.host = [], [], []
        self.on = False

    def wrap(self, eng, lane):
        pre = eng.prefill_fn

        def prefill(tokens, extras):
            t0 = time.time_ns()
            out = pre(tokens, extras)
            t1 = time.time_ns()
            if self.on:
                self.prefills.append((t0, t1, int(tokens.shape[0]), int(tokens.shape[1])))
                self.host.append(("prefill.launch", t0, t1))
            return out

        eng.prefill_fn = prefill
        prep, adv = lane._prepare, lane._advance

        def prepare(batch):
            t0 = time.time_ns()
            out = prep(batch)
            t1 = time.time_ns()
            if self.on:
                self.host.append(("decode.prepare", t0, t1))
                if out is not None:
                    ready, (W, _, lens, _, _) = out
                    self.steps.append((t1, len(ready), np.array(lens[:len(ready)])))
            return out

        def advance(batch, W, logits, state, t0):
            s = time.time_ns()
            out = adv(batch, W, logits, state, t0)
            if self.on:
                self.host.append(("decode.sample_and_slice", s, time.time_ns()))
            return out

        lane._prepare, lane._advance = prepare, advance
        if lane._graphs is not None:
            step = lane._graphs.step

            def graph_step(*a):
                s = time.time_ns()
                out = step(*a)
                if self.on:
                    self.host.append(("decode.launch_and_logits_d2h", s, time.time_ns()))
                return out

            lane._graphs.step = graph_step


def run(cell) -> dict:
    port.import_port()
    from repro_torch.models.model import paged_surface
    from repro_torch.serving.paged import PagedServeEngine

    conf, mix = cell.config, cell.traffic
    a = conf["arch"]
    cfg = port.arch_config(a)
    on_card = cell.device_kind == "cuda"
    tf32 = bool(conf["serve"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if on_card:
        dev = port.cuda_device()
    else:
        from repro_torch.core import get_all_devices

        dev = get_all_devices(platform="cpu").get()[0]
    ref = cell.module("reference", conf["family"])
    params = ref.make_params(a, cell.seed, dev.torch_device, DTYPES[conf["serve"]["dtype"]])

    reqs = traffic_mod.Requests(mix, cell.seed, a["vocab_size"])
    clients = int(mix["clients"])
    meta = int(a.get("meta_tokens") or 0)
    max_seq = meta + reqs.max_prompt + reqs.max_output + 1
    spec = paged_surface(cfg)[0](cfg)
    pool_pages = clients * (spec.pages_for(max_seq) + 1) + 2
    palette = [int(w) for w in mix["decode_shapes"]]
    prof = None
    if cell.trace and on_card:
        from benchlib.trace import Profiler

        prof = Profiler(cpu=False)
        prof.start()  # before the engine's threads start: nothing runs beside a start or stop
    eng = PagedServeEngine.from_config(cfg, devices=[dev], params=params, max_seq_len=max_seq,
                                       pool_pages=pool_pages, decode_shapes=palette,
                                       name=f"bench-{cell.workload['name']}")
    rec = _Record()
    try:
        lane = _warm_palette(eng, dev, palette, int(mix.get("warm_prompt", 16)), a["vocab_size"])
        for n in (reqs.max_prompt, min(reqs.prompt_strata)):  # the longest and shortest prefill
            eng.submit(np.arange(n, dtype=np.int32) % a["vocab_size"], 2).get(timeout=600)
        if cell.trace:
            rec.wrap(eng, lane)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        res = _window(cell, eng, reqs, clients, rec)
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        eng.close()
    res["trace"] = prof.stop(*res["traced"]) if prof is not None else None
    del eng, lane
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check = check_served(cell, ref, params, res["done"], res["outs"], reqs, a)
    del params
    correct = check["correct"] and res["failed"] == 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"]}
    if "control_correct" in check:
        out["control_correct"] = bool(check["control_correct"]) and res["failed"] == 0
    if not cell.trace:
        e2e = {"output_tokens_per_s": (res["tokens"] / cell.seconds, "tokens/s"),
               "request_latency_p95_s": (percentile(res["latencies"], 95)
                                         if res["latencies"] else None, "s"),
               "setup_s": (cell.clock.setup_s, "s")}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                          for m in cell.e2e if e2e.get(m["name"], (None,))[0] is not None}
    else:
        run_ctx = SimpleNamespace(arch=a, config=conf, engine=res["engine"], trace=res["trace"],
                                  steps=rec.steps, prefills=rec.prefills, window_s=cell.seconds,
                                  page_size=spec.page_size, module=cell.module)
        out["metrics"] = cell.read_per_layer(run_ctx)
        if res["trace"] is not None:
            t = res["trace"]
            device["busy_s"] = t.busy_s()
            device["window_s"] = t.window_s
            out["breakdown"] = {"device_ops": t.top_ops(10), "idle_gaps": t.idle_gaps(rec.host)}
    out["device"] = device
    out["checks"] = check["checks"]
    for line in check["lines"]:
        print(line, file=sys.stderr)
    return out


def _window(cell, eng, reqs, clients, rec) -> dict:
    """The closed loop: ``ramp_seconds`` of traffic to fill the engine (set-up),
    then the window of ``cell.seconds``, in which a request counts when its
    future resolves; the engine's counters restart as the window opens.
    Every request still in flight at the close is waited for.  A traced
    run keeps the host clock (ns) of the ``trace_seconds`` in the window's
    middle, the stretch its device trace is read over."""
    done_q: "queue.SimpleQueue" = queue.SimpleQueue()
    futures, submitted, nxt = {}, {}, [0]

    def submit(client):
        i = nxt[0]
        nxt[0] += 1
        prompt, new = reqs[i]
        t = time.perf_counter()
        fut = eng.submit(prompt, new, request_id=i)
        submitted[i] = t
        futures[i] = fut
        fut.then(lambda _v, c=client, i=i: done_q.put((c, i, time.perf_counter())),
                 executor="inline")

    trace_s = float(cell.traffic.get("trace_seconds", 2.0))
    for c in range(clients):
        submit(c)
    t_open = time.perf_counter() + float(cell.traffic.get("ramp_seconds", 0.0))
    events = [(t_open, "open")]
    latencies, tokens, completed = [], 0, []
    traced, t0, deadline = [None, None], None, None
    while events:
        now = time.perf_counter()
        if now >= events[0][0]:
            _, what = events.pop(0)
            if what == "open":
                if cell.trace:
                    eng.reset_metrics()
                rec.on = cell.trace
                t0 = cell.clock.open_window()
                deadline = t0 + cell.seconds
                if cell.trace:
                    t_on = t0 + max(0.0, (cell.seconds - trace_s) / 2)
                    events += [(t_on, 0), (t_on + trace_s, 1)]
                events.append((deadline, "close"))
            elif what in (0, 1):
                traced[what] = time.time_ns()
            continue
        try:
            c, i, t_done = done_q.get(timeout=max(events[0][0] - now, 0.0005))
        except queue.Empty:
            continue
        if t0 is not None and t0 <= t_done <= deadline:
            latencies.append(t_done - submitted[i])
            completed.append(i)
            tokens += reqs.lengths(i)[1]
        if deadline is None or time.perf_counter() < deadline:
            submit(c)
    engine = eng.metrics() if cell.trace else None
    rec.on = False
    outs, failed = {}, 0
    limit = time.perf_counter() + 120.0
    for i, fut in futures.items():
        try:
            outs[i] = np.asarray(fut.get(timeout=max(limit - time.perf_counter(), 0.001)))
        except Exception as e:  # noqa: BLE001 - failed, or never came: counted as failed
            failed += 1
            print(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
    return {"attempted": len(futures), "failed": failed, "latencies": latencies,
            "tokens": tokens, "done": completed, "outs": outs, "engine": engine,
            "traced": traced}
