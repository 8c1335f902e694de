"""K1b's least time at the cell's shapes (its least bytes over the HBM
peak) over its device time per launch in the traced slice, in %.
Launches: ``packed_observation_cuda.launches`` over the slice."""

from portbench import peaks, work


def read(run):
    launches = run.slice_counters.get("k1b_launches")
    if run.slice is None or not launches:
        return None
    seconds = run.slice.kernel_seconds("packed_observation_kernel")
    if seconds <= 0:
        return None
    s = run.shapes
    least = work.k1b_bytes(s["B"], s["P"], s["N"], s["W"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
