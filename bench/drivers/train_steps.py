"""Training steps: the port's ``make_train_step`` as ``launch.train`` wires
it (``plan_for`` the shape, AdamW, ``donate=True``), from weights the
reference module makes from the seed, on batches of synthetic tokens drawn
on the device from the seed, every step's rows new.

Set-up builds the one step and drives it through the first
``check_steps`` steps (the same call and feed the window uses), keeping
what ``correct`` compares; the window then runs the same step on, until
``seconds`` have passed, each step ending on its loss read on the host.
``train_tokens_per_s`` is every token trained in the window over its
seconds.  A traced run then profiles ``trace_steps`` more steps (host and
device activity).  Once the program's state is freed, the plain reference
follows the checked steps (``benchlib.train_check``).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import torch

from benchlib import port, train_check

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def batches(seed: int, vocab: int, B: int, S: int, device):
    """Step ``i``'s batch: (B, S + 1) token ids from a generator on the
    device seeded by (seed, i), shifted into tokens and labels."""
    def batch(i: int) -> dict:
        g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + i) % (1 << 63))
        t = torch.randint(0, vocab, (B, S + 1), generator=g, device=device, dtype=torch.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
    return batch


def run(cell) -> dict:
    port.import_port()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.recipes import plan_for
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training import train_step as ts

    conf, mix = cell.config, cell.traffic
    a, tc = conf["arch"], conf["train"]
    cfg = port.arch_config(a)
    on_card = cell.device_kind == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(tc.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(tc.get("tf32", False))
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    B, S = int(mix["batch"]), int(mix["seq"])
    shape = ShapeConfig(cell.workload["traffic"], seq_len=S, global_batch=B, kind="train")
    plan = plan_for(cfg, shape)
    if plan.compute_dtype != tc["compute_dtype"] or plan.remat != tc["remat"]:
        raise RuntimeError(f"the port's plan ({plan.compute_dtype}, remat {plan.remat}) is not "
                           f"the configuration's ({tc['compute_dtype']}, remat {tc['remat']})")
    opt = mix["optimizer"]
    step = ts.make_train_step(cfg, shape, OptConfig(**opt), plan, donate=True)
    ref = cell.module("reference", conf["family"])
    params = ref.make_params(a, cell.seed, device, DTYPES[tc["master_dtype"]])
    state = init_opt_state(params)
    batch = batches(cell.seed, a["vocab_size"], B, S, device)

    n_check = int(mix["check_steps"])
    prog = {"losses": []}
    for i in range(n_check):
        params, state, m = step(params, state, batch(i))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {n: x / (1 - opt["b1"])
                                  for n, x in train_check.norms(state["m"]).items()}
    start = ref.make_params(a, cell.seed, device, DTYPES[tc["master_dtype"]])
    prog["change_norms"] = train_check.change_norms(params, start)
    del start
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t0 = cell.clock.open_window()
    steps, bad = 0, 0
    while True:
        params, state, m = step(params, state, batch(n_check + steps))
        bad += 0 if math.isfinite(float(m["loss"])) else 1
        steps += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    trace = None
    if cell.trace and on_card:
        from benchlib.trace import Profiler

        prof = Profiler(cpu=True)
        prof.warm()
        prof.start()
        for j in range(int(mix["trace_steps"])):
            params, state, m = step(params, state, batch(n_check + steps + j))
            float(m["loss"])
        trace = prof.stop()
    del params, state, m, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    refs = train_check.reference_steps(ref, a, cell.seed, [batch(i) for i in range(n_check)],
                                       opt, device)
    g = train_check.gaps(prog, refs)
    lim = cell.limits
    checks = {k: {"value": g[k], "limit": lim[k]}
              for k in ("loss_rel_gap", "grad_norm_gap", "change_norm_gap") if k in lim}
    checks["nonfinite_losses"] = {"value": bad, "limit": 0}
    lines = [f"check losses program {prog['losses']!r} reference {refs['losses']!r}",
             f"check leaves left out of the change (reference gradient under 1e-3 of the "
             f"median leaf's): {g['left_out']}",
             f"check gaps: loss {g['loss_rel_gap']!r} grad norm {g['grad_norm_gap']!r} "
             f"change norm {g['change_norm_gap']!r}"]
    if cell.control:
        ctrl = train_check.reference_steps(ref, a, cell.seed, [batch(i) for i in range(n_check)],
                                           opt, device, precision="fp8")
        cg = train_check.gaps(ctrl, refs)
        ctrl_checks = {k: {"value": cg[k], "limit": lim[k]} for k in checks if k in cg}
        control_correct = all(c["value"] <= c["limit"] for c in ctrl_checks.values())
        lines += [f"control {k} (fp8 products): {c['value']!r} limit {c['limit']!r}"
                  for k, c in ctrl_checks.items()]
        lines.append(f"control_correct: {control_correct}")
        half = [{k: t[:B // 2] for k, t in batch(i).items()} for i in range(n_check)]
        fg = train_check.gaps(train_check.reference_steps(ref, a, cell.seed, half, opt, device),
                              refs)
        lines.append(f"check fault (half of the batch, the mean over the rest): loss "
                     f"{fg['loss_rel_gap']!r} grad norm {fg['grad_norm_gap']!r} change norm "
                     f"{fg['change_norm_gap']!r}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": steps, "failed": bad}
    if cell.control:
        out["control_correct"] = bool(control_correct)
    if not cell.trace:
        e2e = {"train_tokens_per_s": steps * B * S / window_s, "setup_s": cell.clock.setup_s}
        out["metrics"] = {m_["name"]: {"value": e2e[m_["name"]], "unit": m_["unit"]}
                          for m_ in cell.e2e if m_["name"] in e2e}
    else:
        run_ctx = SimpleNamespace(arch=a, config=conf, trace=trace,
                                  module=cell.module,
                                  train={"steps": steps, "window_s": window_s, "batch": B,
                                         "seq": S, "compute_dtype": tc["compute_dtype"]})
        out["metrics"] = cell.read_per_layer(run_ctx)
        if trace is not None:
            device_info["busy_s"] = trace.busy_s()
            device_info["window_s"] = trace.window_s
            spans = [r for r in trace.ranges if r[0].startswith("train.")]
            out["breakdown"] = {"device_ops": trace.top_ops(10),
                                "idle_gaps": trace.idle_gaps(spans)}
    out["device"] = device_info
    out["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    return out
