"""The least bytes one ``step_autoreset`` must move (from shapes alone:
the grid and state read, the state written, both observations written)
over the HBM peak, over the mean step time of the run's untraced window,
in %. It reads the same work whatever kernels implement the step."""

from portbench import peaks, work


def read(run):
    if run.work.get("steps") != 1 or not run.units:
        return None
    s = run.shapes
    least = work.step_bytes(s["B"], s["P"], s["N"], s["W"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (run.window_s / run.units)
