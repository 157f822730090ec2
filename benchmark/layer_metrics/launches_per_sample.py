"""device: kernel launches per sample over the profiled samples (the
trace's device events less its memory copies and sets)."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not ctx["profiled"]:
        return None
    n = sum(1 for name, _, _ in prof["kernels"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / ctx["profiled"] if n else None
