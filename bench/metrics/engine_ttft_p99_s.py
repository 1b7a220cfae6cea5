"""The engine's own time to first token, 99th percentile, stamped inside
the program (arrival to the prefill's sampled token) over the requests
completed since the window's start."""


def read(run):
    e = getattr(run, "engine", None)
    if not e or not e["requests_completed"]:
        return None
    return e["ttft_p99_s"]
