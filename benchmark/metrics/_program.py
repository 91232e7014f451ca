"""The program's own tracing registry (sparc_ldpc_tpu_torch/utils/
profiling.py: counters and intervals recorded while a profiler runs, so
over a traced window).  A program without one reads as empty."""


def _profiling():
    try:
        from sparc_ldpc_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def counters():
    """The registry's counters as floats, {} where it has none."""
    read = getattr(_profiling(), "counters", None)
    return read() if read is not None else {}


def intervals_ms(name: str):
    """Each recorded interval `name` in milliseconds, [] where none."""
    read = getattr(_profiling(), "intervals_ms", None)
    return [ms for ms, _ in read(name)] if read is not None else []
