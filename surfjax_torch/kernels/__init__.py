"""The pallas backend's kernels, each with its plain PyTorch version."""

# While tools/kernel_check.capture_calls records, the list that collects
# (wrapper name, arguments) of every split-path and priming kernel-wrapper
# call;
# None otherwise.
RECORDED_CALLS = None


def record_call(name: str, args) -> None:
    """args: the call's arguments, or a function that makes them (called
    only while recording)."""
    if RECORDED_CALLS is not None:
        RECORDED_CALLS.append((name, args() if callable(args) else args))
