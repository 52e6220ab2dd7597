"""The mask kernel's share of its roofline, %: the frozen bound of the
window's launches (benchmark/roofline.py, published H100 SXM rates) over
the kernel's device time in the window, by kernel name, from the
profiler."""

from benchmark.metrics import mask_bound_s


def read(run):
    if run.trace is None:
        return None
    bound = mask_bound_s(run)
    spent = sum(v for k, v in run.trace.time_by_name(
        run.out.t0, run.out.t1).items() if "flashe_mask_kernel" in k)
    if not bound or not spent:
        return None
    return bound / spent * 100.0
